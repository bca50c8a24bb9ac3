from .builder import BUILD_DIR, CSRC_DIR, build, load

__all__ = ["BUILD_DIR", "CSRC_DIR", "build", "load"]
