// Batched scenario replay for Hopper (sm_90a): the makespan of one
// step-program family's op table under each scenario of a batch.
//
// replay_solve_kernel replaces the XLA program of the JAX package's
// simulator/batched_replay.py (_compiled :528, called by solve_batch :684):
// a vmapped lax.fori_loop over the op table whose body (run_one, :539-667)
// joins rendezvous as a masked max, integrates compute ops through the
// rank's piecewise slowdown windows (StepFaultModel.compute_end) and scales
// comm ops by the ordered product of the scenario's active link windows.
// It computes, for each scenario, max(clock) after the op loop, bit for bit
// what run_one computes and what the scalar SimuEngine computes on the same
// streams. The plain PyTorch version is batched_replay.replay_solve_plain.
//
// What bounds it on this card, and what the design does about it. The op
// loop is one serial dependence chain: op i reads the clocks, value slots
// and chain tails that ops before it wrote, so no two ops of a scenario run
// at once and the batch is the only parallelism. The work is a few float64
// operations and a few hundred bytes of table per op, so neither the bytes
// nor the operations bound it: the latency of one op's chain does (shared
// memory loads, a warp reduction, dependent float64 arithmetic). One warp
// replays one scenario. Its 32 lanes hold the classes' clocks `clock` and
// comm-done times `cd` in shared memory, lane c owning classes c, c + 32, ...
// (K up to 80 in the v5p-256 example's analysis): the rendezvous max
// (run_one :572) is a warp reduction and the masked clock / cd updates
// (:654-656) are per lane. Every lane computes the op's scalar values
// redundantly (uniform control flow, no divergence); lane 0 writes the
// scalar slots. The value slots v[L + 1]
// (the last one the -inf slot that padded async refs point at) and the chain
// tails v2[C] live in shared memory when they fit (9138 doubles, 73 KB, at
// full width), else v lives in global scratch the wrapper allocates. The op
// table is read from global memory by every warp (L2-resident, shared by the
// batch). Where run_one computes every kind and selects, this kernel
// branches on the kind, which is the family's and the same for every lane
// and every scenario; the selected values are the same.
//
// Exactness. Every product, quotient, sum and difference goes through
// __dmul_rn / __ddiv_rn / __dadd_rn / __dsub_rn, which nvcc never
// contracts into a fused multiply-add: that would round once where the
// engine rounds twice (run_one fences the same contraction with abs(),
// :600-604, :632-634). The link product visits the scenario's link windows
// in event order and the slowdown integration visits the class's edges in
// table order with run_one's "passed already" guard (:609-640): both orders
// are kept. A frozen window (multiplier +inf) advances t to the edge and
// leaves the work as it was, as run_one's select does.
//
// The extern "C" entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// op codes: simulator/batched_replay.py (OP_*)
constexpr int OP_COMPUTE = 1;
constexpr int OP_ADVANCE_ABS = 2;
constexpr int OP_ADVANCE_REL = 3;
constexpr int OP_COLL = 4;
constexpr int OP_ASYNC_POST = 5;
constexpr int OP_ASYNC_FINISH = 6;
constexpr int OP_WAIT_COMM = 7;
constexpr int OP_SEND = 8;
constexpr int OP_SEND_SYNC = 9;
constexpr int OP_RECV = 10;

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may opt into

__device__ __forceinline__ double dmax(double a, double b) { return fmax(a, b); }

__device__ __forceinline__ double warp_max(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = dmax(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Batch {
  int n_ops, k, words, g, c, w, e;
  const int* kind;
  const int* rank;
  const double* dur;
  const int* aux;
  const uint32_t* mask;
  const int* refs;
  const double* win_s;
  const double* win_e;
  const double* win_m;
  const double* edges;
  const uint8_t* has_slow;
  const double* link_s;
  const double* link_e;
  const double* link_m;
  const long long* app_bits;
};

// d * the ordered product of this scenario's link windows that apply to
// op i and are active at t (run_one :587-604)
__device__ __forceinline__ double scaled(const Batch& p, int b, int i, double t, double d) {
  const long long bits = p.app_bits[(long long)b * p.n_ops + i];
  double scale = 1.0;
  for (int j = 0; j < p.e; ++j) {
    const double s = p.link_s[b * p.e + j];
    const double e = p.link_e[b * p.e + j];
    if (((bits >> j) & 1) && s <= t && t < e) scale = __dmul_rn(scale, p.link_m[b * p.e + j]);
  }
  return __dmul_rn(d, scale);
}

// wall end of d seconds of work from cr on class r (run_one :609-640)
__device__ double compute_end(const Batch& p, int b, int r, double cr, double d) {
  double res = __dadd_rn(cr, d);
  if (!p.has_slow[b * p.k + r] || d <= 0.0) return res;
  const long long row = (long long)b * p.k + r;
  const double* ws = p.win_s + row * p.w;
  const double* we = p.win_e + row * p.w;
  const double* wm = p.win_m + row * p.w;
  const double* eds = p.edges + row * 2 * p.w;
  double t = cr, work = d;
  for (int s = 0; s <= 2 * p.w; ++s) {
    const double e = s < 2 * p.w ? eds[s] : INFINITY;
    if (!(e > t)) continue;  // an edge passed already
    double mult = 1.0;
    for (int j = 0; j < p.w; ++j)
      if (ws[j] <= t && t < we[j]) mult = __dmul_rn(mult, wm[j]);
    const bool frozen = isinf(mult);
    if (!frozen) {
      const double end = __dadd_rn(t, __dmul_rn(work, mult));
      if (end <= e) return end;
      work = __dsub_rn(work, __ddiv_rn(__dsub_rn(e, t), mult));
    }
    t = e;
  }
  return res;
}

// one warp a scenario: block b replays scenario b
__global__ void __launch_bounds__(32)
replay_solve_kernel(Batch p, double* __restrict__ v_global, double* __restrict__ out) {
  extern __shared__ double smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  double* clock = smem;
  double* cd = clock + p.k;
  double* v2 = cd + p.k;
  double* v = v_global ? v_global + (long long)b * (p.n_ops + 1) : v2 + p.c;
  for (int x = lane; x < p.k; x += 32) clock[x] = cd[x] = 0.0;
  for (int x = lane; x < p.c; x += 32) v2[x] = 0.0;
  for (int x = lane; x < p.n_ops; x += 32) v[x] = 0.0;
  if (lane == 0) v[p.n_ops] = -INFINITY;
  __syncwarp();

  for (int i = 0; i < p.n_ops; ++i) {
    const int op = p.kind[i];
    const int r = p.rank[i];
    const double d = p.dur[i];
    const int a = p.aux[i];
    const uint32_t* msk = p.mask + (long long)i * p.words;
    const double cr = clock[r];
    double new_cr = cr, vval = cr, grp = 0.0;
    switch (op) {
      case OP_COMPUTE: new_cr = compute_end(p, b, r, cr, d); break;
      case OP_ADVANCE_ABS: new_cr = dmax(cr, d); break;
      case OP_ADVANCE_REL: new_cr = dmax(cr, __dadd_rn(cr, d)); break;
      case OP_WAIT_COMM: new_cr = dmax(cr, cd[r]); break;
      case OP_RECV: new_cr = dmax(cr, v[a]); break;
      case OP_SEND: vval = __dadd_rn(cr, scaled(p, b, i, cr, d)); break;
      case OP_SEND_SYNC: {
        const double start = dmax(cr, clock[a]);
        new_cr = vval = __dadd_rn(start, scaled(p, b, i, start, d));
        break;
      }
      case OP_COLL: {
        double m = -INFINITY;
        for (int x = lane; x < p.k; x += 32)
          if ((msk[x >> 5] >> (x & 31)) & 1u) m = dmax(m, clock[x]);
        const double start = warp_max(m);
        grp = __dadd_rn(start, scaled(p, b, i, start, d));
        break;
      }
      case OP_ASYNC_FINISH: {
        double gmax = -INFINITY;
        for (int j = 0; j < p.g; ++j) gmax = dmax(gmax, v[p.refs[(long long)i * p.g + j]]);
        const double start = dmax(gmax, v2[a]);
        grp = __dadd_rn(start, scaled(p, b, i, start, d));
        break;
      }
      default: break;  // OP_NOOP, OP_ASYNC_POST: v[i] = cr
    }
    __syncwarp();  // every lane has read this op's inputs
    if (op == OP_COLL) {
      for (int x = lane; x < p.k; x += 32)
        if ((msk[x >> 5] >> (x & 31)) & 1u) clock[x] = grp;
    } else if (op == OP_ASYNC_FINISH) {
      for (int x = lane; x < p.k; x += 32)
        if ((msk[x >> 5] >> (x & 31)) & 1u) cd[x] = dmax(cd[x], grp);
      if (lane == 0) v2[a] = grp;
    } else if (lane == 0) {
      clock[r] = new_cr;
    }
    if (lane == 0) v[i] = vval;
    __syncwarp();
  }

  double m = -INFINITY;
  for (int x = lane; x < p.k; x += 32) m = dmax(m, clock[x]);
  m = warp_max(m);
  if (lane == 0) out[b] = m;
}

}  // namespace

extern "C" {

// Shared memory of one block: clock[K], cd[K], v2[C] and, unless
// v_global is given, v[L + 1]. Returns cudaErrorInvalidValue when that is
// more than a block may have.
int replay_solve(int n_ops, int k, int words, int g, int c, int w, int e, int batch,
                 const void* kind, const void* rank, const void* dur, const void* aux,
                 const void* mask, const void* refs, const void* win_s, const void* win_e,
                 const void* win_m, const void* edges, const void* has_slow, const void* link_s,
                 const void* link_e, const void* link_m, const void* app_bits, void* v_global,
                 void* out, void* stream) {
  if (n_ops < 0 || k < 1 || batch < 1 || c < 1 || g < 1 || e > 64) return (int)cudaErrorInvalidValue;
  long long doubles = 2LL * k + c + (v_global ? 0 : n_ops + 1LL);
  if (doubles * 8 > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int smem = (int)(doubles * 8);
  cudaError_t err = cudaFuncSetAttribute(replay_solve_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Batch p{n_ops, k, words, g, c, w, e,
          static_cast<const int*>(kind), static_cast<const int*>(rank),
          static_cast<const double*>(dur), static_cast<const int*>(aux),
          static_cast<const uint32_t*>(mask), static_cast<const int*>(refs),
          static_cast<const double*>(win_s), static_cast<const double*>(win_e),
          static_cast<const double*>(win_m), static_cast<const double*>(edges),
          static_cast<const uint8_t*>(has_slow), static_cast<const double*>(link_s),
          static_cast<const double*>(link_e), static_cast<const double*>(link_m),
          static_cast<const long long*>(app_bits)};
  replay_solve_kernel<<<batch, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<double*>(v_global), static_cast<double*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
