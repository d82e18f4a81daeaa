"""Multi-device distribution of the port: a single-process mesh of torch
devices (`mesh.py`), the collective dense Cholesky of a large root front
(`dist_cholesky.py`) and the row-group factorization of narrow mid-tree
levels (`dist_level.py`)."""
