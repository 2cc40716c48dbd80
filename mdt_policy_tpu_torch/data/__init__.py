"""Data side of the port: camera-frame preprocessing and the frozen-tower
embedding cache."""
