// Pipeline-schedule folds for Hopper (sm_90a): the 1F1B or interleaved
// schedule of each candidate of a strategy-search shape group.
//
// fold_levels_kernel replaces the two XLA programs of the JAX package's
// search/batched.py: _jit_fold_1f1b (:459) and _jit_fold_interleaved (:515),
// each jax.jit(jax.vmap(...)) over a lax.scan of the shape's flat op order
// in float64. For each candidate it computes what fold_1f1b (:288) and
// fold_interleaved (:381) compute, the replays of
// PerfLLM.calculate_1f1b_bubble and calculate_interleaved_schedule: each
// stage's end and their maximum, the total. One kernel serves both
// schedules: the 1F1B fold is the interleaved one at vp = 1, and the host
// (search/batched.py fold_table) writes each shape's op table with the
// dependencies and blocking flags the numpy fold uses. The plain PyTorch
// version is torchref/kernels.py fold_schedule_plain, which walks the
// same table the same way.
//
// The op table, int32 [n_ops, 4], n_ops = 2 pp vp mbc, one record an op,
// sorted by dependence level (search/batched.py fold_levels):
//   x: stage | blocking << 8 | backward << 9 | next << 10, next the
//      offset of the first op of the following level
//   y: time row, stage * vp + chunk, into fwd or bwd [pp * vp, n]
//   z: the state slot the op writes (F slots, then B slots)
//   w: the slot it waits on, or -1
// An op's level is one more than that of the previous op on its stage
// and of the op that wrote the slot it waits on, so the ops of a level
// lie on distinct stages and read only what earlier levels wrote.
//
// What bounds it on this card, and what the design does about it. A
// candidate's fold is a chain of dependent float64 additions and
// comparisons; the candidates are independent. For the groups a sweep
// makes (n from one to tens of thousands, n_ops from 8 to about 2000)
// neither bytes nor operations bound it: the chain's depth times the
// latency of one step does. The first kernel walked all n_ops records in
// order, a thread a candidate, with the stage clocks and state slots in
// global scratch: an L2 round trip every step (0.16 us). Here a warp
// walks a candidate a level at a time: its lanes take a level's ops (at
// most pp, on distinct stages; lanes loop where pp > 32), then
// __syncwarp, then the next level, so the chain is the number of levels
// (78 at pp 8, mbc 32, 512 ops; 514 at pp 2, vp 4, mbc 64, 1024 ops).
// The candidate's times, stage clocks and state slots live in shared
// memory, and the block stages the table there once for its candidates;
// each record carries the next level's offset, so the next level's
// records are loaded while this one's are computed. Where they do not fit
// (kernels.py fold_layout), the table is read from global memory and the
// state slots kept in global scratch: the same walk, slower. Each of the
// four cases is its own instantiation, so that a pointer into shared
// memory is known as one and its loads and stores are LDS and STS, not
// generic ones.
//
// Exactness. Sums go through __dadd_rn, which nvcc never contracts into a
// fused multiply-add; the maximum is taken as the fold writes it,
// c >= dep ? c : dep; the blocking term is added under the fold's own
// condition (the record's bit 8) and not as end + flag * blocking, which
// the jitted fold writes (:593). The ops of a level are independent, so
// their order within it changes nothing: every end and total is the
// numpy fold's, bit for bit.
//
// A table that is not level-ordered (a level reaching past the table,
// not advancing, wider than pp, or a record out of range) is refused by
// each block before its walk, which then needs no vote: the block's
// candidates' ends and totals are NaN.
//
// The extern "C" entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 4;      // candidates a block
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may have
constexpr int NEXT_SHIFT = 10;
constexpr unsigned FULL = 0xffffffffu;

struct Fold {
  double* times;  // [2 rows]: fwd rows, then bwd rows
  double* clk;    // [pp]
  double* st;     // [n_ops]
  double p, blk;
  int rows;
};

__device__ __forceinline__ void step(const Fold& f, int4 op) {
  const int s = op.x & 0xff;
  const double c = f.clk[s];
  double start = c;
  if (op.w >= 0) {
    const double dep = __dadd_rn(f.st[op.w], f.p);
    start = c >= dep ? c : dep;
  }
  double end = __dadd_rn(start, f.times[((op.x >> 9) & 1) * f.rows + op.y]);
  f.st[op.z] = end;
  if (op.x & 0x100) end = __dadd_rn(end, f.blk);
  f.clk[s] = end;
}

// whether record k of the table may be walked: its stage, time row and
// slots in range, and its next-level offset that of the record before it
// or, where a level starts, at most pp records on
__device__ __forceinline__ bool record_ok(const int4* tab, int k, int n_ops, int pp, int rows) {
  const int4 op = tab[k];
  const int hi = op.x >> NEXT_SHIFT;
  const int prev = k ? tab[k - 1].x >> NEXT_SHIFT : 0;
  const bool starts = k == prev;
  return (starts ? hi > k && hi - k <= pp : hi == prev) && hi <= n_ops &&
         (k < n_ops - 1 || hi == n_ops) && (op.x & 0xff) < pp && op.y >= 0 && op.y < rows &&
         op.z >= 0 && op.z < n_ops && op.w >= -1 && op.w < n_ops;
}

// TABLE: the op table staged in shared memory (else read where it is);
// STATE: the state slots in shared memory (else in scratch [n, n_ops])
template <bool TABLE, bool STATE>
__global__ void fold_levels_kernel(const int4* __restrict__ ops, int n_ops, int pp, int rows,
                                   int n, const double* __restrict__ fwd,
                                   const double* __restrict__ bwd,
                                   const double* __restrict__ p2p,
                                   const double* __restrict__ blocking,
                                   double* __restrict__ scratch, double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int4* staged = reinterpret_cast<int4*>(smem);
  const int4* tab = TABLE ? staged : ops;
  if (TABLE) {
    for (int k = threadIdx.x; k < n_ops; k += blockDim.x) staged[k] = ops[k];
    __syncthreads();
  }
  // the table's shape, checked once a block so that the walk needs no vote
  bool bad = false;
  for (int k = threadIdx.x; k < n_ops; k += blockDim.x)
    bad = bad || !record_ok(tab, k, n_ops, pp, rows);
  const bool refused = __syncthreads_or(bad);
  const int j = blockIdx.x * warps + warp;
  if (j >= n) return;
  const size_t nn = (size_t)n;
  if (refused) {
    for (int s = lane; s <= pp; s += 32) out[s * nn + j] = NAN;
    return;
  }

  const size_t per = 2 * rows + pp + (STATE ? n_ops : 0);
  double* mine = reinterpret_cast<double*>(smem + (TABLE ? 16 * (size_t)n_ops : 0)) + warp * per;
  Fold f;
  f.times = mine;
  f.clk = mine + 2 * rows;
  f.st = STATE ? f.clk + pp : scratch + (size_t)j * n_ops;
  f.rows = rows;
  f.p = p2p[j];
  f.blk = blocking[j];
  for (int r = lane; r < rows; r += 32) {
    f.times[r] = fwd[r * nn + j];
    f.times[rows + r] = bwd[r * nn + j];
  }
  for (int s = lane; s < pp; s += 32) f.clk[s] = 0.0;
  __syncwarp();

  int lo = 0;
  int4 op = tab[min(lane, n_ops - 1)];
  while (lo < n_ops) {
    const int hi = __shfl_sync(FULL, op.x >> NEXT_SHIFT, 0);
    const int4 next = tab[min(hi + lane, n_ops - 1)];  // in flight while this level runs
    if (lane < hi - lo) step(f, op);
    for (int k = lo + 32 + lane; k < hi; k += 32) step(f, tab[k]);  // levels wider than a warp
    __syncwarp();
    lo = hi;
    op = next;
  }

  for (int s = lane; s < pp; s += 32) out[s * nn + j] = f.clk[s];
  if (lane == 0) {
    double total = f.clk[0];
    for (int s = 1; s < pp; ++s) {
      const double e = f.clk[s];
      if (e > total) total = e;
    }
    out[pp * nn + j] = total;
  }
}

template <bool TABLE, bool STATE>
cudaError_t launch(int blocks, int threads, size_t smem, cudaStream_t stream,
                   const int4* ops, int n_ops, int pp, int rows, int n, const double* fwd,
                   const double* bwd, const double* p2p, const double* blocking,
                   double* scratch, double* out) {
  cudaError_t e = cudaFuncSetAttribute(fold_levels_kernel<TABLE, STATE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  fold_levels_kernel<TABLE, STATE><<<blocks, threads, smem, stream>>>(
      ops, n_ops, pp, rows, n, fwd, bwd, p2p, blocking, scratch, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ops int32 [n_ops, 4], level-ordered; fwd, bwd float64 [pp * vp, n];
// p2p, blocking float64 [n]; scratch float64 [n, n_ops] when the state is
// not in shared memory (else unused); out float64 [pp + 1, n]: each
// stage's end, then the total. cands candidates a block; table_smem and
// state_smem as kernels.py fold_layout chose them. Returns
// cudaErrorInvalidValue when an argument is out of range.
int fold_schedule(int n_ops, int pp, int vp, int n, int cands, int table_smem, int state_smem,
                  const void* ops, const void* fwd, const void* bwd, const void* p2p,
                  const void* blocking, void* scratch, void* out, void* stream) {
  if (pp < 1 || pp > 255 || vp < 1 || n < 1 || n_ops < 1 || n_ops % (2 * pp * vp) ||
      n_ops >= (1 << (31 - NEXT_SHIFT)) || cands < 1 || cands > MAX_WARPS ||
      (!state_smem && !scratch))
    return (int)cudaErrorInvalidValue;
  const int rows = pp * vp;
  const size_t per = 8 * ((size_t)2 * rows + pp + (state_smem ? n_ops : 0));
  const size_t smem = (table_smem ? 16 * (size_t)n_ops : 0) + cands * per;
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int blocks = (n + cands - 1) / cands;
#define FOLD_ARGS                                                                        \
  blocks, 32 * cands, smem, (cudaStream_t)stream, (const int4*)ops, n_ops, pp, rows, n,  \
      (const double*)fwd, (const double*)bwd, (const double*)p2p, (const double*)blocking, \
      (double*)scratch, (double*)out
  cudaError_t e = table_smem ? (state_smem ? launch<true, true>(FOLD_ARGS)
                                           : launch<true, false>(FOLD_ARGS))
                             : (state_smem ? launch<false, true>(FOLD_ARGS)
                                           : launch<false, false>(FOLD_ARGS));
#undef FOLD_ARGS
  return (int)e;
}

}  // extern "C"
