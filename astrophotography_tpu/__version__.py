"""Version of the astrophotography_tpu package (semver)."""

__version__ = "0.6.0"
