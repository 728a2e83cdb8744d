from .adamvs import AdaMVS
from .casmvsnet import CasMVSNet
from .msrednet import MSREDNet
from .ucsnet import UCSNet

MODELS = {"adamvs": AdaMVS, "casmvsnet": CasMVSNet, "msrednet": MSREDNet,
          "ucsnet": UCSNet}


def check_model_type(model_type: str) -> None:
    """Raise ValueError unless the port runs `model_type`."""
    if model_type not in MODELS:
        raise ValueError(f"unknown model_type {model_type!r}; one of "
                         f"{sorted(MODELS)}")


def build_model(model_type: str, **kwargs):
    """Instantiate a cascade MVS network by config name."""
    check_model_type(model_type)
    return MODELS[model_type](**kwargs)


__all__ = ["AdaMVS", "CasMVSNet", "MSREDNet", "UCSNet", "build_model",
           "check_model_type"]
