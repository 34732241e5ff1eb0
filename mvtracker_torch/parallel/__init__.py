"""Data parallelism and the model-axis splits over `torch.distributed`
(`mesh.py`)."""
