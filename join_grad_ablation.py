"""Where the time of the sparse joins' backward kernels goes, on one NVIDIA
GPU.

    python3 join_grad_ablation.py

1. builds ``csrc/sparse_join_grad.cu`` as it is and variants of it that
   each leave out one part of the work or replace one design choice with
   an alternative it was measured against (a leave-out probe by text
   substitution of the source, each of which must apply exactly once;
   an alternative by a -D flag of one of its tuning constants), one
   nvcc per variant, all started together;
2. trains ``car.fhd.config`` (key-match, B = 6) one step on a synthetic
   KITTI clone, as ``chip_smoke.py``'s SECOND training phase does, and
   records one more step's backward calls;
3. at the largest join of that step (and at a 32 -> 32 join), checks the
   unmodified build against the port's wrappers bit for bit, then times
   dW (the hits of each tap + the reduction GEMM) and dfeatures (the
   inverse + the kernel over the hit rows) of every variant in turns
   (``chip_smoke.take_turns``: CUDA events behind a GPU sleep, L2
   flushed) and splits the unmodified halves by kernel (torch.profiler);
4. at the largest join, times the key-match backward's rulebook lookup
   (``keymatch_rulebook``, a hash table of the keys) on its keys, which
   ascend there, and on the same keys shuffled, beside a fill of the
   table's keys (the launch's clear) and ``_merge_lookup``, in turns;
   prints one JSON line.

The variants compute wrong results on purpose where they leave work out:
they are timing probes, built into a directory of their own, and no part
of the port calls them.  Needs one GPU; exits non-zero without one.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke
from automatic_as_built_reconstruction_tpu_torch.data import batching
from automatic_as_built_reconstruction_tpu_torch.ops import (
    _build, sparse_gather_gemm)
from automatic_as_built_reconstruction_tpu_torch.train import (
    train as train_mod)

SOURCE = _build.CSRC_DIR / "sparse_join_grad.cu"
# name -> (what the variant changes, [(old, new), ...], {macro: value}).
# The first group leaves out one part of the work, by text substitution of
# the source; the second replaces one design choice with an alternative
# that was measured against it, by a -D flag of one of the kernel file's
# tuning constants (JG_*).
VARIANTS = {
    "kernels": ("nothing", [], {}),
    "dw_no_products": ("leaves out dW's products (the hits, copies and "
                       "partials stay)", [
        ("    gw_multiply<MT, NT>(acc, ring + (c % STAGES) * G::STAGE, wk, "
         "m0, n0);\n", "")], {}),
    "dw_no_copies": ("leaves out dW's feature-row copies", [
        ("  gather_rows<GW_THREADS>(As, G::LDA, CH, nh - hb, feats + ci0, "
         "Cin,", "  if (false) gather_rows<GW_THREADS>(As, G::LDA, CH, "
         "nh - hb, feats + ci0, Cin,")], {}),
    "df_no_products": ("leaves out dfeatures' products (lookups, copies "
                       "and barriers stay)", [
        ("    const int mine = f < nf ? (nf - f + G::WF - 1) / G::WF : 0;",
         "    const int mine = 0;")], {}),
    "df_no_weights": ("copies W[k] once a block, not once a tap", [
        ("  if (h0 == 0)\n    gather_rows<GF_THREADS>(Ws, ld, CIN, CIN, Wk,",
         "  if (false)\n    gather_rows<GF_THREADS>(Ws, ld, CIN, CIN, Wk,")],
        {}),
    "dw_blocks_16": ("16 dW blocks an SM, not 32 (fewer, longer parts)", [],
                     {"JG_GW_BLOCKS_PER_SM": 16}),
    "dw_chunk_64": ("64 hits a stage, not 32", [], {"JG_CH": 64}),
    "df_rows_64": ("64 input rows a dfeatures block, not 128", [],
                   {"JG_GF_TJ": 64}),
    "df_unit_16": ("units of one fragment, not two", [], {"JG_UNIT": 16}),
    "df_eight_warps": ("eight warps a dfeatures block, not four", [],
                       {"JG_GF_WARPS": 8}),
}
_P, _I = ctypes.c_void_p, ctypes.c_int


def variant_sources() -> dict:
    """{name: CUDA source} of every variant; raises where a substitution
    does not occur exactly once in ``SOURCE``."""
    text = SOURCE.read_text()
    sources = {}
    for name, (_, subs, _) in VARIANTS.items():
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} occurs "
                                   f"{src.count(old)} times in the source")
            src = src.replace(old, new)
        sources[name] = src
    return sources


def build(out_dir: Path) -> dict:
    """{name: loaded library} of every variant, one nvcc each, all
    started together."""
    procs = {}
    for name, src in variant_sources().items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        so = out_dir / f"lib{name}.so"
        defines = [f"-D{k}={v}" for k, v in VARIANTS[name][2].items()]
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *defines, "-o", str(so),
             str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _fn(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def halves(lib, feats, idx, found, dout, w, N):
    """(dW, dfeatures) of one join through ``lib``'s C interface, as the
    port's wrappers call it."""
    B, K, R = idx.shape
    Cin, Cout = feats.shape[-1], dout.shape[-1]
    stream = torch.cuda.current_stream().cuda_stream
    chunks = _fn(lib, "tap_hits_chunks", (_I, _I))(B, R)
    parts = _fn(lib, "tap_grad_parts", (_I,) * 5)(B, R, K, Cin, Cout)
    hits_fn = _fn(lib, "tap_hits_launch", (_P,) * 5 + (_I,) * 4 + (_P,))
    grad_w = _fn(lib, "tap_grad_launch", (_P,) * 6 + (_I,) * 6 + (_P,))
    inverse = _fn(lib, "rulebook_inverse_launch",
                  (_P,) * 4 + (_I,) * 4 + (_P,))
    grad_f = _fn(lib, "grad_features_launch", (_P,) * 4 + (_I,) * 6 + (_P,))
    collisions = torch.zeros((), dtype=torch.int32, device="cuda")

    def dw():
        counts_c = torch.empty((K, chunks), dtype=torch.int32, device="cuda")
        hits = torch.empty((K, B * R, 2), dtype=torch.int32, device="cuda")
        counts = torch.empty(K, dtype=torch.int32, device="cuda")
        _build.check(hits_fn(idx.data_ptr(), found.data_ptr(),
                             counts_c.data_ptr(), hits.data_ptr(),
                             counts.data_ptr(), B, K, R, N, stream), "hits")
        partial = torch.empty((K, parts, Cin, Cout), device="cuda")
        out = torch.empty((K, Cin, Cout), device="cuda")
        _build.check(grad_w(feats.data_ptr(), dout.data_ptr(),
                            hits.data_ptr(), counts.data_ptr(),
                            partial.data_ptr(), out.data_ptr(), B, N, R, K,
                            Cin, Cout, stream), "dW")
        return out

    def df():
        inv = torch.empty((B, K, N), dtype=torch.int32, device="cuda")
        _build.check(inverse(idx.data_ptr(), found.data_ptr(),
                             inv.data_ptr(), collisions.data_ptr(), B, K, R,
                             N, stream), "inverse")
        out = torch.empty((B, N, Cin), device="cuda")
        _build.check(grad_f(dout.data_ptr(), inv.data_ptr(), w.data_ptr(),
                            out.data_ptr(), B, N, R, K, Cin, Cout, stream),
                     "dfeatures")
        return out

    return dw, df


def step_calls(card: str) -> tuple:
    """(dW calls, dfeatures calls, rulebook lookups) of one car.fhd
    training step (B = 6) after one step of ``train()`` on a synthetic
    KITTI clone; dW calls and lookups join by join in one order."""
    sgg = sparse_gather_gemm
    with torch.enable_grad(), tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "kitti"
        chip_smoke.write_clone(root, False, "join backward ablation", card)
        config = chip_smoke.kitti_config(chip_smoke.SECOND_TRAIN_CONFIG, tmp,
                                         root)
        try:
            state = train_mod.train(config, tmp / "m", max_steps=1,
                                    display_step=1, device="cuda")
        except train_mod.CapacitySaturationError:
            config = chip_smoke.kitti_config(
                chip_smoke.SECOND_TRAIN_CONFIG, tmp, root,
                chip_smoke.MEASURED_SITE_CAPS)
            state = train_mod.train(config, tmp / "m2", max_steps=1,
                                    display_step=1, device="cuda")
        prep_ds, loader = train_mod.Bundle(config).input_reader(
            training=True, seed=1)
        stream = loader._index_stream()
        example = train_mod.to_device(batching.merge_batch(
            [prep_ds.example(*next(stream)) for _ in range(6)]), "cuda")
        step_fn = train_mod.make_train_step(train_mod.Bundle(config))
        wcalls, fcalls, mcalls = [], [], []
        with chip_smoke.recording(sgg, "join_grad_weights", wcalls), \
                chip_smoke.recording(sgg, "join_grad_features", fcalls), \
                chip_smoke.recording(sgg, "keymatch_rulebook", mcalls):
            step_fn(state, example)
        torch.cuda.synchronize()
    return wcalls, fcalls, mcalls


def rulebook_probe(mcall, card: str) -> dict:
    """The rulebook lookup at one join (``keymatch_rulebook``: a hash
    table of the keys), on its keys, which ascend there, and on the same
    keys with the rows shuffled, beside a fill of the table's keys (what
    the launch's clear writes) and ``_merge_lookup``, in turns, after
    checking that the shuffled keys give the same rulebook through the
    permutation.  -> {key: median ms}."""
    sgg = sparse_gather_gemm
    (in_keys, q_keys), _ = mcall
    in_keys, q_keys = in_keys.contiguous(), q_keys.contiguous()
    perm = torch.randperm(in_keys.shape[-1], device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
    shuffled = in_keys[:, perm].contiguous()
    idx, found = sgg.keymatch_rulebook(in_keys, q_keys)
    sidx, sfound = sgg.keymatch_rulebook(shuffled, q_keys)
    if not (torch.equal(found, sfound)
            and torch.equal(perm[sidx[sfound].long()].int(), idx[found])):
        raise AssertionError("the rulebook of the shuffled keys differs")
    bits = _build.function("sparse_gather_gemm", "keymatch_table_bits",
                           (_I,))(in_keys.shape[-1])
    table = torch.empty((in_keys.shape[0], 1 << bits), dtype=torch.int32,
                        device="cuda")
    turns = chip_smoke.take_turns({
        "keys_ascending": lambda: sgg.keymatch_rulebook(in_keys, q_keys),
        "keys_shuffled": lambda: sgg.keymatch_rulebook(shuffled, q_keys),
        "table_clear": lambda: table.fill_(-1),
        "merge_lookup": lambda: sgg.keymatch_rulebook_plain(in_keys,
                                                            q_keys)}, 20)
    chip_smoke.log(
        f"join backward ablation [{card}]: rulebook lookup at the largest "
        f"join (B={in_keys.shape[0]} N={in_keys.shape[-1]} "
        f"K={q_keys.shape[-2]} R={q_keys.shape[-1]}, table of 2^{bits} "
        f"slots a scan), in turns: "
        + "; ".join(f"{k} {chip_smoke.fmt_range(v)}"
                    for k, v in turns.items()))
    return {k: v[0] for k, v in turns.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("join_grad_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sgg = sparse_gather_gemm
    card = chip_smoke.toolchain()
    wcalls, fcalls, mcalls = step_calls(card)
    torch.set_grad_enabled(False)
    by_rulebook = {id(c[0][1]): c for c in fcalls}
    with_f = [c for c in wcalls if id(c[0][1]) in by_rulebook]
    largest = max(with_f, key=lambda c: int(c[0][2].sum())
                  * c[0][0].shape[-1] * c[0][3].shape[-1])
    at = next(i for i, c in enumerate(wcalls) if c is largest)
    result = {"card": card, "rulebook_ms": rulebook_probe(mcalls[at], card)}
    joins = {"largest": largest}
    narrow = [c for c in with_f if c[0][0].shape[-1] == 32
              and c[0][3].shape[-1] == 32]
    if narrow:
        joins["32x32"] = narrow[0]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for what, wcall in joins.items():
            feats, idx, found, dout = (t.contiguous() for t in wcall[0])
            (fdout, _, _, w, N), _ = by_rulebook[id(wcall[0][1])]
            shape = (f"B={feats.shape[0]} N={N} R={idx.shape[-1]} "
                     f"K={idx.shape[-2]} Cin={feats.shape[-1]} "
                     f"Cout={dout.shape[-1]} hits={int(found.sum())}")
            fns = {name: halves(lib, feats, idx, found, dout,
                                w.contiguous(), N)
                   for name, lib in libs.items()}
            dw, df = fns["kernels"]
            if not (torch.equal(dw(), sgg.join_grad_weights(
                    feats, idx, found, dout)) and torch.equal(
                        df(), sgg.join_grad_features(fdout, idx, found, w,
                                                     N))):
                raise AssertionError("the unmodified build differs from the "
                                     "port's kernels")
            split = {half: chip_smoke.device_profile(fn, iters=10,
                                                     windows=2)[1]
                     for half, fn in (("dw", dw), ("dfeatures", df))}
            turns = chip_smoke.take_turns(
                {f"{name}:{half}": fn for name, pair in fns.items()
                 for half, fn in zip(("dw", "dfeatures"), pair)}, 10)
            chip_smoke.log(f"join backward ablation [{card}]: {what} join "
                           f"{shape}; by kernel {json.dumps(split)}")
            for name in fns:
                chip_smoke.log(
                    f"  {name} ({VARIANTS[name][0]}): dW "
                    f"{chip_smoke.fmt_range(turns[name + ':dw'])}, "
                    f"dfeatures "
                    f"{chip_smoke.fmt_range(turns[name + ':dfeatures'])}")
            result[what] = {"shape": shape, "by_kernel_ms": split,
                            "in_turns_ms": {k: v[0]
                                            for k, v in turns.items()}}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
