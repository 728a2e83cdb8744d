from .adamvs import AdaMVS

# CasMVSNet, UCSNet and MSREDNet are ROADMAP section A items
_NOT_PORTED = ("casmvsnet", "ucsnet", "msrednet")


def build_model(model_type: str, **kwargs):
    """Instantiate a cascade MVS network by config name."""
    if model_type == "adamvs":
        return AdaMVS(**kwargs)
    if model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported yet (ROADMAP A: "
            "CasMVSNet/UCSNet with K2v, MSREDNet with K4/K5)")
    raise ValueError(f"unknown model_type {model_type!r}")


__all__ = ["AdaMVS", "build_model"]
