// Pillar scatter: pillar feature rows -> dense BEV canvas rows, and its
// transpose, the gather of the canvas gradient back to the rows.
//
// Replaces the TPU kernel
//   automatic_as_built_reconstruction_tpu/ops/pallas/pillar_scatter.py
//   ::scatter_sorted_to_canvas (kernel body _kernel, pallas_call :103),
// which builds each 1024-cell canvas tile as a one-hot matmul on the MXU
// because the TPU has no row scatter.  Hopper stores rows directly, so
// this kernel is a plain coalesced copy:
//
//   canvas[b, lin[b, v], :] = feats[b, v, :]   for 0 <= lin[b, v] < hw
//
// The wrapper (ops/pillar_scatter.py) allocates the canvas zeroed, so
// empty cells stay 0 and rows with lin outside [0, hw) are dropped.
// Ids are unique per scan and may come in any order (no voxelizer repeats
// a cell; each thread stores at its own cell, so nothing depends on the
// ids ascending); duplicates are not an accepted input.
//
// Bound: bytes.  Per call it must read feats (B*V*C*4) and lin (B*V*4)
// and write the canvas (B*hw*C*4, the zero fill included); there is no
// arithmetic.  Design for that bound: one thread per 16-byte float4 of
// a row (one 16-byte load and store per thread, adjacent threads on
// adjacent addresses of a row, a 64-float row = 16 threads); no shared
// memory, no atomics.  The wrapper passes only C % 4 == 0 and 16-byte
// aligned feats (every pillar config has C = 32 or 64).
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
// row feeds at most one pillar row and no gradient is summed.  Bound:
// bytes.  It must read the canvas gradient at the valid rows' cells
// (rows * C * 4), the ids (B*V*4), and write dfeats (B*V*C*4).  Same
// design as the forward, mirrored: one thread per float4 of an output
// row, a 16-byte load from the row's cell and a 16-byte store, adjacent
// threads on adjacent addresses; every output element is written (0 for
// a dropped row), so the wrapper allocates dfeats uninitialised.
#include <cuda_runtime.h>

__global__ void pillar_scatter_kernel(const float4* __restrict__ feats,
                                      const int* __restrict__ lin,
                                      float4* __restrict__ canvas,
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

extern "C" int pillar_scatter_launch(const float* feats, const int* lin,
                                     float* canvas, int B, int V, int C,
                                     int hw, cudaStream_t stream) {
  const long long rows = (long long)B * V;
  if (rows == 0 || C == 0) return (int)cudaSuccess;
  const int cw = C / 4;
  const int threads = 256;
  long long blocks = (rows * cw + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond this
  pillar_scatter_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(feats), lin,
      reinterpret_cast<float4*>(canvas), rows, V, cw, hw);
  return (int)cudaGetLastError();
}

__global__ void pillar_gather_kernel(const float4* __restrict__ dcanvas,
                                     const int* __restrict__ lin,
                                     float4* __restrict__ dfeats,
                                     long long rows, int V, int cw, int hw) {
  const long long total = rows * cw;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long row = t / cw;
    const int c = (int)(t - row * cw);
    const int cell = __ldg(lin + row);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (cell >= 0 && cell < hw) {
      const long long b = row / V;
      v = dcanvas[(b * hw + cell) * cw + c];
    }
    dfeats[t] = v;
  }
}

extern "C" int pillar_gather_launch(const float* dcanvas, const int* lin,
                                    float* dfeats, int B, int V, int C,
                                    int hw, cudaStream_t stream) {
  const long long rows = (long long)B * V;
  if (rows == 0 || C == 0) return (int)cudaSuccess;
  const int cw = C / 4;
  const int threads = 256;
  long long blocks = (rows * cw + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond this
  pillar_gather_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(dcanvas), lin,
      reinterpret_cast<float4*>(dfeats), rows, V, cw, hw);
  return (int)cudaGetLastError();
}
