// The edge kernels of edge_mpnn.cu and edge_mpnn_runs.cu at a tile height
// the caller names, for scripts/edge_tile_sweep.py: the shipped launch
// picks the height itself (edge_mma.cuh tile_rows), and this entry fixes
// it, so each height can be timed on the same inputs.  fp32 with 16-byte
// rows and W resident only (the §8 model's shapes).  edge_mpnn_runs takes
// its carry scratch and fold (carry.cuh) as the shipped entry does.
#include "edge_mpnn/edge_mpnn.cu"
#include "edge_mpnn/edge_mpnn_runs.cu"

namespace {

template <int ROWS>
cudaError_t launch_rows(bool runs, const Plan& p, cudaStream_t s) {
  using Kernel = void (*)(EdgeArgs);
  const Kernel kernel =
      runs ? Kernel(&edge_mpnn_runs_kernel<kFloat32, ROWS, true, false>)
           : Kernel(&edge_mpnn_kernel<kFloat32, ROWS, true, false>);
  static int64_t allowed[2] = {48 * 1024, 48 * 1024};
  cudaError_t err = allow_smem(kernel, p.layout.total, &allowed[runs]);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, edge::kThreads, p.layout.total, s>>>(p.args);
  return cudaGetLastError();
}

}  // namespace

// edge_mpnn (runs = 0) or edge_mpnn_runs (runs = 1) in fp32 with tiles of
// 16 x rows edges, rows in 2 .. 8; arguments as edge_mpnn_launch's, the
// output fp32 [n_tgt, m], and for runs the carry scratch of
// carry_floats(carry_pieces, m) floats (ceil(e / 32) pieces cover every
// height).  Returns the cudaError_t (cudaErrorInvalidValue for a shape
// that is not fp32-vector-W-resident or a height out of range).
extern "C" int edge_tile_sweep_launch(int runs, int rows, const void* h_src,
                                      const void* h_tgt, const int* src,
                                      const int* tgt, const void* w,
                                      const void* b, float* out,
                                      float* carry, long long carry_pieces,
                                      int e, int n_src, int n_tgt, int ds,
                                      int dt, int m, int act, void* stream) {
  Plan p;
  const int64_t tiles = (static_cast<int64_t>(e) + 16 * rows - 1) /
                        (16 * rows);
  if (!plan(h_src, h_tgt, src, tgt, w, b, out, runs ? carry : nullptr, e,
            n_src, n_tgt, ds, dt, m, kFloat32, act, rows, &p) ||
      !p.vec || p.stream || e <= 0 || rows < 2 || rows > 8 ||
      (runs && (carry == nullptr || carry_pieces < tiles)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<int64_t>(n_tgt) * m * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (rows) {
    case 2: err = launch_rows<2>(runs, p, s); break;
    case 3: err = launch_rows<3>(runs, p, s); break;
    case 4: err = launch_rows<4>(runs, p, s); break;
    case 5: err = launch_rows<5>(runs, p, s); break;
    case 6: err = launch_rows<6>(runs, p, s); break;
    case 7: err = launch_rows<7>(runs, p, s); break;
    default: err = launch_rows<8>(runs, p, s); break;
  }
  if (err == cudaSuccess && runs) err = carry_fold(carry, out, tiles, m, s);
  return static_cast<int>(err);
}
