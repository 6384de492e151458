"""Device ops: voxelization, box decode, NMS and the CUDA kernels with
their plain PyTorch versions, registered as operators in ``library.py``."""
