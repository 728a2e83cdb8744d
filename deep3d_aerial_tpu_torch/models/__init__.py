from .adamvs import AdaMVS
from .msrednet import MSREDNet

MODELS = {"adamvs": AdaMVS, "msrednet": MSREDNet}
# CasMVSNet and UCSNet are a ROADMAP section A item
_NOT_PORTED = ("casmvsnet", "ucsnet")


def check_model_type(model_type: str) -> None:
    """Raise unless the port runs `model_type`: NotImplementedError naming
    its ROADMAP item for a model not ported yet, ValueError otherwise."""
    if model_type in MODELS:
        return
    if model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported yet (ROADMAP A: "
            "CasMVSNet/UCSNet with K2v, CostRegNet3D and FeatureNet 'fpn')")
    raise ValueError(f"unknown model_type {model_type!r}")


def build_model(model_type: str, **kwargs):
    """Instantiate a cascade MVS network by config name."""
    check_model_type(model_type)
    return MODELS[model_type](**kwargs)


__all__ = ["AdaMVS", "MSREDNet", "build_model", "check_model_type"]
