"""The benchmark of the PyTorch and CUDA port (``brainevent_torch``)."""
