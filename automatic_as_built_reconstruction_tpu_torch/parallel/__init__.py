"""Serving and data parallelism: batched on-device inference, and a 1-D
mesh of ranks over ``torch.distributed`` for training, evaluation and
serving."""
from .inference import PodInference, pod_inference_from_checkpoint
from .mesh import Mesh, data_parallel_mesh, replicate, shard_batch

__all__ = ["Mesh", "PodInference", "data_parallel_mesh",
           "pod_inference_from_checkpoint", "replicate", "shard_batch"]
