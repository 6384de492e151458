"""Mean device time a request of the network (the voxel encoder, the middle and the RPN with its heads), from CUDA events the benchmark
records at the stage's ends around the program's own callables, over
every request of the traced window."""
from benchmark.tracing import mean_stage_ms


def read(rec):
    return mean_stage_ms(rec, "network")
