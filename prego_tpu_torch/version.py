__version__ = "0.1.0"  # the JAX package's version (prego_tpu/version.py)
