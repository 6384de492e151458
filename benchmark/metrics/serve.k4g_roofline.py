"""K4g, the key-match join (``ops/sparse_gather_gemm.py::keymatch_gemm``):
the least time the joins it ran need (2 * rulebook hits * Cin * Cout
operations at the float32 ceiling, or its features, keys, weights and
output moved once, whichever is longer) over the device time of the
kernels launched inside its calls, in the profiled slice.  A request's
calls run its leading sparse convolutions in order (the dense tail runs
the rest), so n calls a request are the reference's first n layers."""
from benchmark import roofline

TARGETS = [("automatic_as_built_reconstruction_tpu_torch.models.middle",
            "keymatch_gemm", "bench.k4g")]


def read(rec):
    us = rec["slice"].device_us_in("bench.k4g")
    calls = rec["calls"].get("bench.k4g")
    served = rec["slice_served"]
    if not us or not calls or len(calls) % len(served):
        return None
    n = len(calls) // len(served)
    need = 0.0
    for r, k in enumerate(served):
        layers = rec["work"][k].get("sparse")
        if not layers or n > len(layers):
            return None
        for call, (hits, cin, cout) in zip(calls[r * n:(r + 1) * n],
                                           layers[:n]):
            (B, n_in, _), (_, taps, n_out) = call[0], call[2]
            need += roofline.bound_s(
                roofline.join_flops(hits, cin, cout),
                roofline.join_bytes(B * n_in, B * n_out, cin, cout, taps))
    return 100.0 * need / (us * 1e-6)
