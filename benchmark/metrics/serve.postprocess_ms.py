"""Mean device time a request of decode and NMS (`models/voxelnet.py::predict`, K2 inside), from CUDA events the benchmark
records at the stage's ends around the program's own callables, over
every request of the traced window."""
from benchmark.tracing import mean_stage_ms


def read(rec):
    return mean_stage_ms(rec, "postprocess")
