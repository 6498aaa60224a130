// Batched scenario replay for Hopper (sm_90a): the makespan of one
// step-program family's op table under each scenario of a batch.
//
// replay_levels_kernel replaces the XLA program of the JAX package's
// simulator/batched_replay.py (_compiled :528, called by solve_batch :684):
// a vmapped lax.fori_loop over the op table whose body (run_one, :539-667)
// joins rendezvous as a masked max, integrates compute ops through the
// rank's piecewise slowdown windows (StepFaultModel.compute_end) and scales
// comm ops by the ordered product of the scenario's active link windows.
// It computes, for each scenario, max(clock) after the op table, bit for
// bit what run_one computes and what the scalar SimuEngine computes on the
// same streams. The plain PyTorch version is
// batched_replay.replay_solve_plain, which walks the ops one at a time.
//
// What bounds it on this card, and what the design does about it. An op
// is a few float64 operations and a few dozen bytes, so neither the bytes
// nor the operations bound the replay: the depth of the family's
// dependence DAG does, times the latency of one op (shared-memory loads,
// dependent float64 arithmetic) and of one block barrier. The lowering
// serialises K independent class streams into one valid order; the DAG
// through the state slots (clock[x], cd[x], v2[c], v[i]) is far shallower:
// 146 levels for every family of the v5p-256 example, against up to 9137
// ops (batched_replay.level_schedule). So the host sorts the table by
// level once per family (batched_replay.build_tables) and the kernel
// replays a level at a time:
//
// * One block a scenario, a thread for each op of the widest level (up to
//   1024). The scenario's state lives in shared memory: clock[K], cd[K],
//   v2[C] and the value slots v[L + 1] (the last one the -inf slot that
//   padded async refs point at; 73 KB at L 9137), v in global scratch where
//   it does not fit (past about 28k ops). Its slowdown windows and link
//   windows are copied into shared memory at the start where they fit.
// * For each level (a "step": a level wider than STEP_CAP ops is cut into
//   several), the level's ops are dealt to the block: each collective
//   (OP_COLL, a K-wide masked max and masked write) to a warp, every other
//   op to a thread. No op of a level reads or writes a slot that another
//   op of the level writes, so the ops run at once, read the values earlier
//   levels wrote (the values the serial order gives them) and write without
//   atomics. Then one __syncthreads(). The host sorts a level's ops by
//   kind, so most warps take one branch of the op switch.
// * While the block replays a level, the Tensor Memory Accelerator copies
//   the slices of the table of the levels ahead into a ring of stages in
//   shared memory: a level's op records, its group rows (member masks and
//   async refs of the collectives and async finishes) and this scenario's
//   link bits, three 1-D bulk copies (cp.async.bulk) completing on the
//   stage's mbarrier. A copy takes about as long as a level of the largest
//   family (about 0.8 us a level with one stage ahead, whatever the level's
//   width), so the ring holds up to 8 stages and the copies run up to 7
//   levels ahead: the table's loads leave the levels' critical path. The
//   block's last thread, which takes the fewest ops, issues them. The step
//   table (where each level starts) sits in shared memory where it fits.
// * Shared memory at the largest family (L 9137, K 80, widest level 1040):
//   v 73 KB, a stage (1040 records, their link bits, 16 group rows) 26 KB,
//   the state, windows and step table a few KB: v and 5 stages fit. The
//   host (kernels.replay_smem) gives two stages and the state first, then
//   the step table, the windows and v where they fit, then more stages.
//
// Exactness. Every product, quotient, sum and difference goes through
// __dmul_rn / __ddiv_rn / __dadd_rn / __dsub_rn, which nvcc never
// contracts into a fused multiply-add: that would round once where the
// engine rounds twice (run_one fences the same contraction with abs(),
// :600-604, :632-634). The link product visits the scenario's link windows
// in event order and the slowdown integration visits the class's edges in
// table order with run_one's "passed already" guard (:609-640): both orders
// are kept. A frozen window (multiplier +inf) advances t to the edge and
// leaves the work as it was, as run_one's select does. Maxima are exact in
// any order. Each op reads the values it reads in the lowered order, so
// every makespan is the serial replay's.
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
constexpr int MAX_STAGES = 8;     // stages of the table's ring in shared memory

// one op of the table (batched_replay.OP_RECORD): kr = kind | arg << 8, arg
// the class, or for a collective and an async finish its row among the
// step's group rows
struct Op {
  double dur;
  int kr;
  int aux;
};
static_assert(sizeof(Op) == 16, "a record is 16 bytes");

struct Params {
  int n_ops, k, words, g, row, c, w, e, n_steps, n_stages, app_stride, win_smem, steps_smem;
  int ops_bytes, bits_bytes, stage_bytes;  // a stage: records, link bits, group rows
  const Op* ops;
  const int4* steps;  // (first slot, collectives, first group row, 0), 1 sentinel
  const int* groups;  // [rows, row]: member mask words, then refs
  const double* win_s;
  const double* win_e;
  const double* win_m;
  const double* edges;
  const uint8_t* has_slow;
  const double* link_s;
  const double* link_e;
  const double* link_m;
  const long long* app_bits;  // [B, app_stride], table order
};

__host__ __device__ constexpr int align16(long long x) { return (int)((x + 15) & ~15LL); }

__device__ __forceinline__ double dmax(double a, double b) { return fmax(a, b); }

__device__ __forceinline__ double warp_max(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = dmax(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// barrier inits made visible to the bulk copies (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bytes (a multiple of 16) from 16-byte aligned global memory into shared
// memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// step s0's slice of the table (its end is s1's start) and this scenario's
// link bits for it into a stage; one thread
__device__ void load_step(const Params& p, int b, int4 s0, int4 s1, unsigned char* stage,
                          uint64_t* bar) {
  const uint32_t ob = (uint32_t)(s1.x - s0.x) * 16u;
  const int first = s0.x & ~1, last = (s1.x + 1) & ~1;  // 16-byte aligned link words
  const uint32_t bb = p.e > 0 ? (uint32_t)(last - first) * 8u : 0u;
  const uint32_t gb = (uint32_t)(s1.z - s0.z) * (uint32_t)p.row * 4u;
  mbar_expect_tx(bar, ob + bb + gb);
  bulk_load(stage, p.ops + s0.x, ob, bar);
  if (bb) bulk_load(stage + p.ops_bytes, p.app_bits + (long long)b * p.app_stride + first, bb, bar);
  if (gb) bulk_load(stage + p.ops_bytes + p.bits_bytes, p.groups + (long long)s0.z * p.row, gb, bar);
}

// the scenario's state and fault arrays, in shared memory or global
struct State {
  double* clock;
  double* cd;
  double* v2;
  double* v;
  const double* ls;  // link windows: start, end, multiplier
  const double* le;
  const double* lm;
  const uint8_t* has_slow;
  const double* ws;  // [K, W] slowdown windows and [K, 2W] edges
  const double* we;
  const double* wm;
  const double* eds;
};

// d * the ordered product of this scenario's link windows that apply to
// the op (bits) and are active at t (run_one :587-604)
__device__ __forceinline__ double scaled(const Params& p, const State& s, long long bits, double t,
                                         double d) {
  double scale = 1.0;
  for (int j = 0; j < p.e; ++j)
    if (((bits >> j) & 1) && s.ls[j] <= t && t < s.le[j]) scale = __dmul_rn(scale, s.lm[j]);
  return __dmul_rn(d, scale);
}

// wall end of d seconds of work from cr on class r (run_one :609-640)
__device__ double compute_end(const Params& p, const State& s, int r, double cr, double d) {
  double res = __dadd_rn(cr, d);
  if (!s.has_slow[r] || d <= 0.0) return res;
  const double* ws = s.ws + (long long)r * p.w;
  const double* we = s.we + (long long)r * p.w;
  const double* wm = s.wm + (long long)r * p.w;
  const double* eds = s.eds + (long long)r * 2 * p.w;
  double t = cr, work = d;
  for (int k = 0; k <= 2 * p.w; ++k) {
    const double e = k < 2 * p.w ? eds[k] : INFINITY;
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

// a collective, by one warp: the members' masked max, the link scale, and
// every member's clock set to the end
__device__ void collective(const Params& p, const State& s, const Op& o, long long bits,
                           const uint32_t* msk, int lane) {
  double m = -INFINITY;
  for (int x = lane; x < p.k; x += 32)
    if ((msk[x >> 5] >> (x & 31)) & 1u) m = dmax(m, s.clock[x]);
  const double start = warp_max(m);
  const double end = __dadd_rn(start, scaled(p, s, bits, start, o.dur));
  __syncwarp();  // every lane has read the members' clocks
  for (int x = lane; x < p.k; x += 32)
    if ((msk[x >> 5] >> (x & 31)) & 1u) s.clock[x] = end;
}

// any other op, by one thread; slot is its value slot
__device__ void single(const Params& p, const State& s, const Op& o, long long bits,
                       const int* grp, int slot) {
  const int op = o.kr & 0xff;
  const int arg = o.kr >> 8;
  const double d = o.dur;
  const int a = o.aux;
  if (op == OP_ASYNC_FINISH) {  // the chained stream op of a group (run_one :641-656)
    const uint32_t* msk = reinterpret_cast<const uint32_t*>(grp + arg * p.row);
    const int* refs = grp + arg * p.row + p.words;
    double gmax = -INFINITY;
    for (int j = 0; j < p.g; ++j) gmax = dmax(gmax, s.v[refs[j]]);
    const double start = dmax(gmax, s.v2[a]);
    const double end = __dadd_rn(start, scaled(p, s, bits, start, d));
    for (int w = 0; w < p.words; ++w)
      for (uint32_t m = msk[w]; m; m &= m - 1) {
        const int x = w * 32 + __ffs(m) - 1;
        s.cd[x] = dmax(s.cd[x], end);
      }
    s.v2[a] = end;
    return;
  }
  const int r = arg;
  const double cr = s.clock[r];
  double vval = cr;
  switch (op) {
    case OP_COMPUTE: s.clock[r] = compute_end(p, s, r, cr, d); break;
    case OP_ADVANCE_ABS: s.clock[r] = dmax(cr, d); break;
    case OP_ADVANCE_REL: s.clock[r] = dmax(cr, __dadd_rn(cr, d)); break;
    case OP_WAIT_COMM: s.clock[r] = dmax(cr, s.cd[r]); break;
    case OP_RECV: s.clock[r] = dmax(cr, s.v[a]); break;
    case OP_SEND: vval = __dadd_rn(cr, scaled(p, s, bits, cr, d)); break;
    case OP_SEND_SYNC: {
      const double start = dmax(cr, s.clock[a]);
      s.clock[r] = vval = __dadd_rn(start, scaled(p, s, bits, start, d));
      break;
    }
    default: break;  // OP_ASYNC_POST, OP_NOOP: v = the clock
  }
  s.v[slot] = vval;
}

// one block a scenario: block b replays scenario b, a level at a time
__global__ void __launch_bounds__(1024)
replay_levels_kernel(Params p, double* __restrict__ v_global, double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  // the thread that loads the stages: the last, which takes the fewest ops
  const bool loader = tid == (int)blockDim.x - 1;
  const int k = p.k, w = p.w, e = p.e;

  // layout: barriers, the reduction, the stages, the step table, the state,
  // the fault arrays, v
  unsigned char* q = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(q);
  double* red = reinterpret_cast<double*>(q + 8 * MAX_STAGES);
  unsigned char* stages = q + 8 * MAX_STAGES + 32 * 8;
  q = stages + p.n_stages * p.stage_bytes;
  const int4* steps = p.steps;
  if (p.steps_smem) {
    int4* copy = reinterpret_cast<int4*>(q);
    for (int x = tid; x <= p.n_steps; x += blockDim.x) copy[x] = __ldg(&p.steps[x]);
    steps = copy;
    q += 16LL * (p.n_steps + 1);
  }
  State s;
  s.clock = reinterpret_cast<double*>(q);
  s.cd = s.clock + k;
  s.v2 = s.cd + k;
  q += align16((2LL * k + p.c) * 8);
  double* links = reinterpret_cast<double*>(q);
  s.ls = links;
  s.le = links + e;
  s.lm = links + 2 * e;
  q += align16(3LL * e * 8);
  uint8_t* hs = q;
  s.has_slow = hs;
  q += align16(k);
  const long long kw = (long long)k * w, row = (long long)b * kw;
  if (p.win_smem) {
    double* wins = reinterpret_cast<double*>(q);
    for (long long x = tid; x < kw; x += blockDim.x) {
      wins[x] = p.win_s[row + x];
      wins[kw + x] = p.win_e[row + x];
      wins[2 * kw + x] = p.win_m[row + x];
    }
    for (long long x = tid; x < 2 * kw; x += blockDim.x) wins[3 * kw + x] = p.edges[2 * row + x];
    s.ws = wins;
    s.we = wins + kw;
    s.wm = wins + 2 * kw;
    s.eds = wins + 3 * kw;
    q += align16(5 * kw * 8);
  } else {
    s.ws = p.win_s + row;
    s.we = p.win_e + row;
    s.wm = p.win_m + row;
    s.eds = p.edges + 2 * row;
  }
  s.v = v_global ? v_global + (long long)b * (p.n_ops + 1) : reinterpret_cast<double*>(q);

  for (int x = tid; x < k; x += blockDim.x) {
    s.clock[x] = s.cd[x] = 0.0;
    hs[x] = p.has_slow[(long long)b * k + x];
  }
  for (int x = tid; x < p.c; x += blockDim.x) s.v2[x] = 0.0;
  for (int x = tid; x < e; x += blockDim.x) {
    links[x] = p.link_s[(long long)b * e + x];
    links[e + x] = p.link_e[(long long)b * e + x];
    links[2 * e + x] = p.link_m[(long long)b * e + x];
  }
  for (int x = tid; x < p.n_ops; x += blockDim.x) s.v[x] = 0.0;
  if (tid == 0) s.v[p.n_ops] = -INFINITY;

  if (loader) {
    for (int x = 0; x < p.n_stages; ++x) mbar_init(&bars[x]);
    fence_proxy_async();
    for (int l = 0; l < p.n_stages - 1 && l < p.n_steps; ++l)
      load_step(p, b, __ldg(&p.steps[l]), __ldg(&p.steps[l + 1]), stages + l * p.stage_bytes,
                &bars[l]);
  }
  __syncthreads();

  uint32_t phase = 0;  // parity of stage st's fill that step l reads
  for (int l = 0, st = 0; l < p.n_steps; ++l) {
    const int4 s0 = steps[l], s1 = steps[l + 1];
    // step l + n_stages - 1 goes into the stage step l - 1 read, which every
    // thread left at the barrier that ended step l - 1
    const int ahead = l + p.n_stages - 1, sa = st == 0 ? p.n_stages - 1 : st - 1;
    if (loader && ahead < p.n_steps)
      load_step(p, b, steps[ahead], steps[ahead + 1], stages + sa * p.stage_bytes, &bars[sa]);
    mbar_wait(&bars[st], phase);
    const unsigned char* stage = stages + st * p.stage_bytes;
    const Op* ops = reinterpret_cast<const Op*>(stage);
    const long long* bits = reinterpret_cast<const long long*>(stage + p.ops_bytes) + (s0.x & 1);
    const int* grp = reinterpret_cast<const int*>(stage + p.ops_bytes + p.bits_bytes);
    const int n = s1.x - s0.x, nc = s0.y;
    for (int j = warp; j < nc; j += nwarps)
      collective(p, s, ops[j], e > 0 ? bits[j] : 0,
                 reinterpret_cast<const uint32_t*>(grp + (ops[j].kr >> 8) * p.row), lane);
    for (int j = nc + tid; j < n; j += blockDim.x)
      single(p, s, ops[j], e > 0 ? bits[j] : 0, grp, s0.x + j);
    __syncthreads();
    if (++st == p.n_stages) {
      st = 0;
      phase ^= 1u;
    }
  }

  double m = -INFINITY;
  for (int x = tid; x < k; x += blockDim.x) m = dmax(m, s.clock[x]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = warp_max(lane < nwarps ? red[lane] : -INFINITY);
    if (lane == 0) out[b] = m;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block: MAX_STAGES barriers, 32 doubles for
// the reduction, n_stages stages (max_width records, max_width + 2 link
// words when e > 0, max_groups group rows), the step table when
// steps_smem, clock[K], cd[K], v2[C], the link windows, has_slow[K], the
// slowdown windows and edges when win_smem, and v[L + 1] unless v_global
// is given. Returns cudaErrorInvalidValue when a block cannot have that
// much or an argument is out of range.
int replay_levels(int n_ops, int k, int words, int g, int row, int c, int w, int e, int batch,
                  int n_steps, int n_stages, int max_width, int max_groups, int threads,
                  int app_stride, int win_smem, int steps_smem, const void* ops,
                  const void* steps, const void* groups,
                  const void* win_s, const void* win_e, const void* win_m, const void* edges,
                  const void* has_slow, const void* link_s, const void* link_e,
                  const void* link_m, const void* app_bits, void* v_global, void* out,
                  void* stream) {
  if (n_ops < 0 || k < 1 || batch < 1 || c < 1 || g < 1 || e < 0 || e > 64 || w < 0 ||
      threads < 32 || threads > 1024 || threads % 32 || row % 4 || row < words + g ||
      app_stride < n_ops || app_stride % 2 || n_stages < 2 || n_stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.n_ops = n_ops;
  p.k = k;
  p.words = words;
  p.g = g;
  p.row = row;
  p.c = c;
  p.w = w;
  p.e = e;
  p.n_steps = n_steps;
  p.n_stages = n_stages;
  p.app_stride = app_stride;
  p.win_smem = win_smem;
  p.steps_smem = steps_smem;
  p.ops_bytes = align16(16LL * max_width);
  p.bits_bytes = e > 0 ? align16(8LL * (max_width + 2)) : 0;
  p.stage_bytes = p.ops_bytes + p.bits_bytes + align16(4LL * row * max_groups);
  long long smem = 8 * MAX_STAGES + 32 * 8 + (long long)n_stages * p.stage_bytes +
                   align16((2LL * k + c) * 8) +
                   align16(3LL * e * 8) + align16(k);
  if (steps_smem) smem += 16LL * (n_steps + 1);
  if (win_smem) smem += align16(5LL * k * w * 8);
  if (!v_global) smem += (n_ops + 1LL) * 8;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(replay_levels_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  p.ops = static_cast<const Op*>(ops);
  p.steps = static_cast<const int4*>(steps);
  p.groups = static_cast<const int*>(groups);
  p.win_s = static_cast<const double*>(win_s);
  p.win_e = static_cast<const double*>(win_e);
  p.win_m = static_cast<const double*>(win_m);
  p.edges = static_cast<const double*>(edges);
  p.has_slow = static_cast<const uint8_t*>(has_slow);
  p.link_s = static_cast<const double*>(link_s);
  p.link_e = static_cast<const double*>(link_e);
  p.link_m = static_cast<const double*>(link_m);
  p.app_bits = static_cast<const long long*>(app_bits);
  replay_levels_kernel<<<batch, threads, (int)smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<double*>(v_global), static_cast<double*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
