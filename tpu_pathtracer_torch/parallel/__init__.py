"""The multi-device split (tiles.py) and its multi-process mesh and image
gather (multihost.py)."""
