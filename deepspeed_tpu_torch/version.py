__version__ = "0.1.0"
version = __version__
