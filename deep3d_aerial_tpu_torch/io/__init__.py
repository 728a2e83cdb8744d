from .pfm import read_pfm, write_pfm
from . import text_formats

__all__ = ["read_pfm", "write_pfm", "text_formats"]
