// Pillar scatter: pillar feature rows -> dense BEV canvas rows, and its
// transpose, the gather of the canvas gradient back to the rows.
//
// Replaces the TPU kernel
//   automatic_as_built_reconstruction_tpu/ops/pallas/pillar_scatter.py
//   ::scatter_sorted_to_canvas (kernel body _kernel, pallas_call :103),
// which builds each 1024-cell canvas tile as a one-hot matmul on the MXU
// because the TPU has no row scatter (in float32 or bfloat16 rows: the
// one-hot product is accumulated in float32 and cast back to the rows'
// type, :55-57, an exact copy since each cell takes at most one row).
// Hopper stores rows directly, so this kernel is a plain coalesced copy:
//
//   canvas[b, lin[b, v], :] = feats[b, v, :]   for 0 <= lin[b, v] < hw
//
// It copies each row as 16-byte chunks and never looks at the values, so
// one kernel serves float32 rows (C % 4 == 0: a 64-float row is 16
// chunks) and bfloat16 rows (C % 8 == 0: a 64-value row is 8 chunks), bit
// for bit; the wrapper passes the chunks a row holds.
//
// The wrapper (ops/pillar_scatter.py) allocates the canvas zeroed, so
// empty cells stay 0 and rows with lin outside [0, hw) are dropped.
// Ids are unique per scan and may come in any order (no voxelizer repeats
// a cell; each thread stores at its own cell, so nothing depends on the
// ids ascending); duplicates are not an accepted input.
//
// Bound: bytes.  Per call it must read feats (B*V*C*e, e the element
// size) and lin (B*V*4) and write the canvas (B*hw*C*e, the zero fill
// included); there is no arithmetic.  Design for that bound: one thread
// per 16-byte chunk of a row (one 16-byte load and store per thread,
// adjacent threads on adjacent addresses of a row); no shared memory, no
// atomics.  The wrapper passes only rows of a whole number of chunks and
// 16-byte aligned feats (every pillar config has C = 32 or 64).
//
// pillar_gather_kernel is the backward of the scatter (the JAX package
// has no Pallas backward here: in training it scatters through XLA,
// models/pointpillars.py:262-266, and XLA transposes that scatter into a
// row gather):
//
//   dfeats[b, v, :] = dcanvas[b, lin[b, v], :]   for 0 <= lin[b, v] < hw
//                   = 0                          otherwise
//
// Ids are unique per scan (the forward's precondition), so each canvas
// row feeds at most one pillar row and no gradient is summed: the
// bfloat16 backward is a copy too.  Bound: bytes.  It must read the
// canvas gradient at the valid rows' cells (rows * C * e), the ids
// (B*V*4), and write dfeats (B*V*C*e).  Same design as the forward,
// mirrored: one thread per 16-byte chunk of an output row, a 16-byte load
// from the row's cell and a 16-byte store, adjacent threads on adjacent
// addresses; every output element is written (0 for a dropped row), so
// the wrapper allocates dfeats uninitialised.
#include <cuda_runtime.h>

__global__ void pillar_scatter_kernel(const uint4* __restrict__ feats,
                                      const int* __restrict__ lin,
                                      uint4* __restrict__ canvas,
                                      long long rows, int V, int cw,
                                      int hw) {
  const long long total = rows * cw;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long row = t / cw;
    const int c = (int)(t - row * cw);
    const int cell = __ldg(lin + row);
    if (cell >= 0 && cell < hw) {
      const long long b = row / V;
      canvas[(b * hw + cell) * cw + c] = feats[t];
    }
  }
}

// feats [B, V, cw chunks of 16 bytes], lin [B, V] -> canvas [B, hw, cw]
extern "C" int pillar_scatter_launch(const void* feats, const int* lin,
                                     void* canvas, int B, int V, int cw,
                                     int hw, cudaStream_t stream) {
  const long long rows = (long long)B * V;
  if (rows == 0 || cw == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (rows * cw + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond this
  pillar_scatter_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      reinterpret_cast<const uint4*>(feats), lin,
      reinterpret_cast<uint4*>(canvas), rows, V, cw, hw);
  return (int)cudaGetLastError();
}

__global__ void pillar_gather_kernel(const uint4* __restrict__ dcanvas,
                                     const int* __restrict__ lin,
                                     uint4* __restrict__ dfeats,
                                     long long rows, int V, int cw, int hw) {
  const long long total = rows * cw;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long row = t / cw;
    const int c = (int)(t - row * cw);
    const int cell = __ldg(lin + row);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (cell >= 0 && cell < hw) {
      const long long b = row / V;
      v = dcanvas[(b * hw + cell) * cw + c];
    }
    dfeats[t] = v;
  }
}

// dcanvas [B, hw, cw chunks of 16 bytes], lin [B, V] -> dfeats [B, V, cw]
extern "C" int pillar_gather_launch(const void* dcanvas, const int* lin,
                                    void* dfeats, int B, int V, int cw,
                                    int hw, cudaStream_t stream) {
  const long long rows = (long long)B * V;
  if (rows == 0 || cw == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (rows * cw + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond this
  pillar_gather_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      reinterpret_cast<const uint4*>(dcanvas), lin,
      reinterpret_cast<uint4*>(dfeats), rows, V, cw, hw);
  return (int)cudaGetLastError();
}
