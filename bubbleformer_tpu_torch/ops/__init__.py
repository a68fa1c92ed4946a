"""Kernel wrappers with their plain PyTorch versions (``ops/temporal_block_mega.py``:
K1, ``ops/axial_lane.py``: K2) and the shared plain attention math."""
