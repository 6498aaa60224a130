// Pipeline-schedule folds for Hopper (sm_90a): the 1F1B or interleaved
// schedule of each candidate of a strategy-search shape group.
//
// fold_schedule_kernel replaces the two XLA programs of the JAX package's
// search/batched.py: _jit_fold_1f1b (:459) and _jit_fold_interleaved (:515),
// each jax.jit(jax.vmap(...)) over a lax.scan of the shape's flat op order
// in float64. For each candidate it computes what fold_1f1b (:288) and
// fold_interleaved (:381) compute, the replays of
// PerfLLM.calculate_1f1b_bubble and calculate_interleaved_schedule: each
// stage's end and their maximum, the total. One kernel serves both
// schedules: the 1F1B fold is the interleaved one at vp = 1, and the host
// (search/batched.py fold_table) writes each shape's op table in the flat
// order of its schedule with the dependencies and blocking flags the
// numpy fold uses. The plain PyTorch version is
// torchref/kernels.py fold_schedule_plain, which walks the same table.
//
// The op table, int32 [n_ops, 4], n_ops = 2 pp vp mbc, one record an op:
//   x: stage | blocking << 8 | backward << 9
//   y: time row, stage * vp + chunk, into fwd or bwd [pp * vp, n]
//   z: the state slot the op writes (F slots, then B slots)
//   w: the slot it waits on, or -1
//
// What bounds it on this card, and what the design does about it. A
// candidate's fold is a chain of n_ops dependent steps, each a few float64
// additions and a comparison on values written by earlier steps; the
// candidates are independent. For the groups a sweep makes (n from tens
// to tens of thousands, n_ops from 8 to about 2000) neither bytes nor
// operations bound the fold: the chain's length times the latency of one
// step does (its loads of the stage clock and the slot it waits on, two
// dependent additions, its stores). This first kernel is the simple one:
// a thread a candidate, every thread walking the same op table in order,
// so a warp's loads of a record are one broadcast and its loads and
// stores of the state, laid out [slot, candidate] in global scratch, are
// coalesced. A warp a candidate, a level-wise walk as in replay.cu or the
// state in shared memory are work for later.
//
// Exactness. Sums go through __dadd_rn, which nvcc never contracts into a
// fused multiply-add; the maximum is taken as the fold writes it,
// c >= dep ? c : dep; the blocking term is added under the fold's own
// condition (the record's bit 8) and not as end + flag * blocking, which
// the jitted fold writes (:593). So every end and total is the numpy
// fold's, bit for bit.
//
// The extern "C" entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__global__ void fold_schedule_kernel(const int4* __restrict__ ops, int n_ops, int pp, int n,
                                     const double* __restrict__ fwd,
                                     const double* __restrict__ bwd,
                                     const double* __restrict__ p2p,
                                     const double* __restrict__ blocking,
                                     double* __restrict__ state, double* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const size_t nn = (size_t)n;
  double* ends = out;  // [pp, n]: each stage's clock, then its end
  for (int s = 0; s < pp; ++s) ends[s * nn + j] = 0.0;
  const double p = p2p[j];
  const double blk = blocking[j];
  for (int k = 0; k < n_ops; ++k) {
    const int4 op = ops[k];
    const int s = op.x & 0xff;
    const double* times = (op.x & 0x200) ? bwd : fwd;
    const double c = ends[s * nn + j];
    double start = c;
    if (op.w >= 0) {
      const double dep = __dadd_rn(state[(size_t)op.w * nn + j], p);
      start = c >= dep ? c : dep;
    }
    double end = __dadd_rn(start, times[(size_t)op.y * nn + j]);
    state[(size_t)op.z * nn + j] = end;
    if (op.x & 0x100) end = __dadd_rn(end, blk);
    ends[s * nn + j] = end;
  }
  double total = ends[j];
  for (int s = 1; s < pp; ++s) {
    const double e = ends[s * nn + j];
    if (e > total) total = e;
  }
  out[pp * nn + j] = total;
}

}  // namespace

extern "C" {

// ops int32 [n_ops, 4]; fwd, bwd float64 [pp * vp, n]; p2p, blocking
// float64 [n]; state float64 [n_ops, n] scratch; out float64 [pp + 1, n]:
// each stage's end, then the total. Returns cudaErrorInvalidValue when an
// argument is out of range.
int fold_schedule(int n_ops, int pp, int vp, int n, const void* ops, const void* fwd,
                  const void* bwd, const void* p2p, const void* blocking, void* state,
                  void* out, void* stream) {
  if (pp < 1 || pp > 255 || vp < 1 || n < 1 || n_ops < 1 || n_ops % (2 * pp * vp))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  fold_schedule_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int4*)ops, n_ops, pp, n, (const double*)fwd, (const double*)bwd,
      (const double*)p2p, (const double*)blocking, (double*)state, (double*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
