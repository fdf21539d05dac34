// The fused fork--execute epoch for Hopper (sm_90a): the specialised
// families "pc" and "reactive" (K3), the traced-mechanism-id family "fork"
// (K4), both math modes, and the CU-tiled fork epoch (K5, at the end).
//
// Replaces repro/kernels/epoch_fused.py:epoch_fused (body _epoch_kernel ->
// _epoch_math): K3 for the specialised run_sim families, K4 for the batched
// sweep, where one launch steps every grid row of a family. One epoch:
//   context gathers -> predict (PC table or reactive state) -> per-domain
//   argmin select -> 11-way execute (NF fork rows + the selected row) ->
//   oldest-first WF allocation -> global memory-traffic scale -> barrier /
//   committed counters, transition dead time, energy -> estimator -> table
//   update with hit rate.
//
// Bound on this card: at 64 CUs x 40 WFs x 10 states an epoch reads and
// writes ~0.3 MB per row (the 64 x 128 x 3 table in and out dominates) and
// does ~1 MFLOP, so the card could finish it in well under 1 us; the kernel
// is launch- and latency-bound. The design is the simple correct one:
//   * one CTA per simulation row (blockIdx.x is the row: run_sim launches
//     one, a grid family all of its rows at once); the row's program rates
//     and the three cum_t rows live in dynamic shared memory, with per-WF
//     scratch beside them. Rows share nothing, so a row's bits do not
//     depend on which rows share its launch;
//   * one warp per CU, two adjacent WFs per lane (WF <= 64); the 11 execute
//     rows are looped, never materialised;
//   * the one cross-CU dependency, the memory-traffic total of each row,
//     is a fixed-order reduction in shared memory between two passes: pass
//     A computes every row's allocation and traffic, pass B recomputes the
//     same values (bitwise, same code) and applies the scale;
//   * lean fork rows take their intra-CU prefix sum as a warp scan (the
//     reference's tril GEMM); the selected row, and every row in exact
//     mode, sums sequentially in WF order like the reference's cumsum;
//   * the argmin takes the first minimum; the quantised core fraction
//     rounds half to even (rintf); int casts truncate; no float atomics;
//   * the table update walks, per slot, the CUs mapped to that table and
//     their WFs in index order: deterministic sums, out-of-range table ids
//     match no table (dropped), while lookups clamp them;
//   * the family is a template parameter, so the specialised instantiations
//     carry none of the fork family's per-row mechanism logic. In the fork
//     family a row's traced id picks its predictor (reactive ids predict
//     from the CU state, the others from the table), its reactive
//     estimator (counter models in id order, the fork-exact one last) and
//     whether the table and per-WF state advance (pc ids only; a reactive
//     row skips the table walk and copies the table through). The hit rate
//     is written for every id.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB: a CTA's share of an H100 SM
// returned, before any launch, when one CTA's shared memory cannot hold
// a row (or a block of one); not a cudaError_t value
constexpr int kRowTooWide = -1;

enum { FAM_PC = 0, FAM_REACTIVE = 1, FAM_FORK = 2 };
// estimator of a row: the counter CU models, the fork-exact model, none
enum { M_STALL = 0, M_LEAD = 1, M_CRIT = 2, M_CRISP = 3, EST_FORK = 4,
       EST_NONE = -1 };

}  // namespace

// Field order mirrors repro_torch/kernels/epoch_fused.py:_EpochArgs.
// Every per-row operand is contiguous with a leading row axis of R rows
// (R = 1 for run_sim); the programs are a stack of W padded programs
// (Pp blocks each) that row r reads through prow[r] (null: program 0),
// with its logical block count Prow[r] (null: P). The shared table map
// tid is one (CU,) vector. Fork rows read their traced id from mech[r];
// n_react ids predict reactively, react_models packs the counter model of
// ids 0..n_react-2 four bits each, pc_mask flags the table-maintaining ids
// and id_ctr_pc is the counter-driven one among them. The CU-tiled fork
// epoch (K5) alone reads block_cu and hands scratch from pass to pass, per
// row: (NF+1, CU) traffic partials traf, (CU) hit counts hit_cu and each
// WF's table slot idx (CU, WF).
struct EpochArgs {
  const float* i0r; const float* sr; const float* cum_t;
  const float* pos; const float* eps;
  const float* ti0; const float* tse; const float* tcnt; const int* tid;
  const float* wfi; const float* wfs;
  const float* ri0; const float* rse;
  const float* fprev; const float* eacc; const float* tacc;
  const float* F; const float* scal; const float* pw;
  const int* prow; const int* Prow; const int* mech;
  float* pos_o; float* ti0_o; float* tse_o; float* tcnt_o;
  float* wfi_o; float* wfs_o; float* ri0_o; float* rse_o;
  float* fsel_o; float* eacc_o; float* tacc_o; float* work_o;
  float* energy_o; float* err_o; int* fidx_o; float* tsens_o; float* hit_o;
  int P, Pp, CU, WF, NF, T, E, CPD, IPB, OFFB;
  int family, fork_est, cu_model, lean;
  int R, n_react, react_models, pc_mask, id_ctr_pc;
  float* traf; int* hit_cu; int* idx;
  int block_cu;
};

namespace {

struct Pw {
  float f_min, f_max, v_min, v_max, c_eff, k_leak, eta0, eta_slope, c_trans;
};

__device__ __forceinline__ float v_of_f(float f, const Pw& p) {
  const float t = (f - p.f_min) / (p.f_max - p.f_min);
  return p.v_min + t * (p.v_max - p.v_min);
}

__device__ __forceinline__ float power_of(float f, float act, const Pw& p) {
  const float v = v_of_f(f, p);
  const float p_dyn = p.c_eff * v * v * f * fminf(fmaxf(act, 0.05f), 1.f);
  const float p_leak = p.k_leak * v;
  const float t = (v - p.v_min) / (p.v_max - p.v_min);
  return (p_dyn + p_leak) / (p.eta0 + p.eta_slope * t);
}

__device__ __forceinline__ float trans_energy(float fo, float fn,
                                              const Pw& p) {
  const float dv = v_of_f(fn, p) - v_of_f(fo, p);
  return p.c_trans * dv * dv;
}

// The arguments of row r: every per-row pointer moved to the row's slice,
// the program pointers to the row's program, P to its logical block count.
// Absent operands stay null.
__device__ __forceinline__ EpochArgs row_args(const EpochArgs& G, int r) {
  EpochArgs A = G;
  const size_t N = (size_t)G.CU * G.WF, C = G.CU;
  const size_t TE = (size_t)G.T * G.E, L = 2 * (size_t)G.Pp + 1;
  const size_t p = G.prow ? (size_t)G.prow[r] : 0;
  A.i0r += p * G.Pp;
  A.sr += p * G.Pp;
  A.cum_t += p * 3 * L;
  if (G.Prow) A.P = G.Prow[r];
#define ROW_OFF(ptr, n) \
  if (A.ptr) A.ptr += (size_t)r * (n)
  ROW_OFF(pos, N); ROW_OFF(eps, N); ROW_OFF(wfi, N); ROW_OFF(wfs, N);
  ROW_OFF(ti0, TE); ROW_OFF(tse, TE); ROW_OFF(tcnt, TE);
  ROW_OFF(ri0, C); ROW_OFF(rse, C); ROW_OFF(fprev, C); ROW_OFF(eacc, C);
  ROW_OFF(tacc, 1); ROW_OFF(F, G.NF); ROW_OFF(scal, 9); ROW_OFF(pw, 11);
  ROW_OFF(pos_o, N); ROW_OFF(wfi_o, N); ROW_OFF(wfs_o, N);
  ROW_OFF(ti0_o, TE); ROW_OFF(tse_o, TE); ROW_OFF(tcnt_o, TE);
  ROW_OFF(ri0_o, C); ROW_OFF(rse_o, C); ROW_OFF(fsel_o, C);
  ROW_OFF(eacc_o, C); ROW_OFF(tacc_o, 1); ROW_OFF(work_o, C);
  ROW_OFF(energy_o, C); ROW_OFF(err_o, C); ROW_OFF(fidx_o, C);
  ROW_OFF(tsens_o, C); ROW_OFF(hit_o, 1);
  ROW_OFF(traf, (size_t)(G.NF + 1) * C); ROW_OFF(hit_cu, C); ROW_OFF(idx, N);
#undef ROW_OFF
  return A;
}

// The mechanism of one row: which predictor it reads, which reactive
// estimator advances the CU state, which per-WF estimator advances the
// table (0 counter-driven, 1 fork-exact); EST_NONE keeps the carry.
struct Mech {
  bool pred_react;
  int react_est;
  int pc_est;
};

template <int FAM>
__device__ __forceinline__ Mech row_mech(const EpochArgs& A, int r) {
  Mech m;
  if (FAM == FAM_PC) {
    m.pred_react = false;
    m.react_est = EST_NONE;
    m.pc_est = A.fork_est ? 1 : 0;
  } else if (FAM == FAM_REACTIVE) {
    m.pred_react = true;
    m.react_est = A.fork_est ? EST_FORK : A.cu_model;
    m.pc_est = EST_NONE;
  } else {
    const int id = A.mech[r];
    m.pred_react = id < A.n_react;
    m.react_est = EST_NONE;
    if (id >= 0 && id < A.n_react - 1) {
      m.react_est = (A.react_models >> (4 * id)) & 15;
    } else if (id == A.n_react - 1) {
      m.react_est = EST_FORK;
    }
    const bool pc = id >= 0 && id < 31 && ((A.pc_mask >> id) & 1);
    m.pc_est = pc ? (id == A.id_ctr_pc ? 0 : 1) : EST_NONE;
  }
  return m;
}

// shared-memory carve-up (floats and ints are both 4 bytes)
struct Smem {
  float *i0r, *sr, *c0, *c1, *c2;
  int* blk;       // (N) starting PC block
  int* idx;       // (N) table slot
  float* dem;     // (N) serial-scan demand; later the i0 estimates
  float* bef;     // (N) serial-scan "before"; later the sens estimates
  float *cf0, *cfL;  // (N) fork rows 0 and NF-1 (accpc)
  float* ipred;   // (CU, NF)
  int* fidx;      // (CU)
  float* fsel;    // (CU)
  int* hits;      // (CU)
  float* traf;    // (NF+1, CU) per-CU traffic partials
  float* scale;   // (NF+1)
};

__host__ __device__ inline size_t smem_words(int Pp, int N, int CU, int NF) {
  return (size_t)2 * Pp + (size_t)3 * (2 * Pp + 1) + (size_t)6 * N +
         (size_t)CU * NF + (size_t)3 * CU + (size_t)(NF + 1) * CU +
         (size_t)(NF + 1);
}

__device__ Smem carve(float* base, int Pp, int N, int CU, int NF) {
  Smem s;
  const int L = 2 * Pp + 1;
  s.i0r = base; s.sr = s.i0r + Pp;
  s.c0 = s.sr + Pp; s.c1 = s.c0 + L; s.c2 = s.c1 + L;
  s.blk = (int*)(s.c2 + L); s.idx = s.blk + N;
  s.dem = (float*)(s.idx + N); s.bef = s.dem + N;
  s.cf0 = s.bef + N; s.cfL = s.cf0 + N;
  s.ipred = s.cfL + N;
  s.fidx = (int*)(s.ipred + CU * NF); s.fsel = (float*)(s.fidx + CU);
  s.hits = (int*)(s.fsel + CU); s.traf = (float*)(s.hits + CU);
  s.scale = s.traf + (NF + 1) * CU;
  return s;
}

// One execute row for the two WFs (w0 = 2 lane, w1 = 2 lane + 1) of CU c:
// demand, memory share, window rates, and the oldest-first allocation.
struct Row {
  float d[2], m[2], i0w[2], sw[2], a[2];
};

__device__ Row exec_row(const EpochArgs& A, const Smem& s, int c, float f,
                        bool lean_form, int lane) {
  const float T = A.scal[0], sigma = A.scal[1], cap = A.scal[2];
  Row r;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int w = 2 * lane + j;
    r.d[j] = r.m[j] = r.i0w[j] = r.sw[j] = 0.f;
    if (w >= A.WF) continue;
    const int n = c * A.WF + w;
    const int blk = s.blk[n];
    const float est = (s.i0r[blk] + s.sr[blk] * f) * T;
    const int nblk = clampi((int)(est / (float)A.IPB) + 1, 1, A.P);
    const int gi = blk + nblk;
    const float nb = (float)nblk;
    const float dci = s.c0[gi] - s.c0[blk];
    const float dcs = s.c1[gi] - s.c1[blk];
    r.m[j] = (s.c2[gi] - s.c2[blk]) / nb;
    const float eps = A.eps[n];
    if (lean_form) {
      r.d[j] = (dci + dcs * f) * ((T * (1.f + sigma * eps)) / nb);
    } else {
      r.i0w[j] = dci / nb;
      r.sw[j] = dcs / nb;
      const float dm = (r.i0w[j] + r.sw[j] * f) * T;
      r.d[j] = dm * (1.f + sigma * eps);
    }
  }
  float b[2];
  if (lean_form) {
    // inclusive warp scan over lane pairs (the reference's tril GEMM)
    const float pair = r.d[0] + r.d[1];
    float incl = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(FULL_MASK, incl, off);
      if (lane >= off) incl = y + incl;
    }
    float excl = __shfl_up_sync(FULL_MASK, incl, 1);
    if (lane == 0) excl = 0.f;
    const float in0 = excl + r.d[0];
    const float in1 = in0 + r.d[1];
    b[0] = in0 - r.d[0];
    b[1] = in1 - r.d[1];
  } else {
    // sequential cumsum in WF order (the reference's op order)
    for (int j = 0; j < 2; ++j) {
      const int w = 2 * lane + j;
      if (w < A.WF) s.dem[c * A.WF + w] = r.d[j];
    }
    __syncwarp();
    if (lane == 0) {
      float acc = 0.f;
      for (int w = 0; w < A.WF; ++w) {
        const float dw = s.dem[c * A.WF + w];
        acc = acc + dw;
        s.bef[c * A.WF + w] = acc - dw;
      }
    }
    __syncwarp();
    for (int j = 0; j < 2; ++j) {
      const int w = 2 * lane + j;
      b[j] = w < A.WF ? s.bef[c * A.WF + w] : 0.f;
    }
    __syncwarp();
  }
  const float C = cap * f * T;
#pragma unroll
  for (int j = 0; j < 2; ++j) r.a[j] = fminf(fmaxf(C - b[j], 0.f), r.d[j]);
  return r;
}

__device__ __forceinline__ Pw load_pw(const EpochArgs& A) {
  return Pw{A.pw[0], A.pw[1], A.pw[2], A.pw[3], A.pw[4],
            A.pw[5], A.pw[6], A.pw[7], A.pw[8]};
}

// The program rates and the three cum_t rows into shared memory.
__device__ __forceinline__ void load_program(const EpochArgs& A,
                                             const Smem& s) {
  for (int i = threadIdx.x; i < A.Pp; i += blockDim.x) {
    s.i0r[i] = A.i0r[i];
    s.sr[i] = A.sr[i];
  }
  const int L = 2 * A.Pp + 1;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    s.c0[i] = A.cum_t[i];
    s.c1[i] = A.cum_t[L + i];
    s.c2[i] = A.cum_t[2 * L + i];
  }
}

// Context + predict I(f) for the A.CU CUs of A (warp per CU): each WF's
// start block and table slot, each CU's table hits and predicted rate
// over the ladder.
template <int FAM>
__device__ __forceinline__ void predict(const EpochArgs& A, const Smem& s,
                                        const Mech& mech) {
  constexpr bool kTable = FAM != FAM_REACTIVE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int NF = A.NF, WF = A.WF;
  const float T = A.scal[0], cap = A.scal[2];
  for (int c = warp; c < A.CU; c += nwarps) {
    float i0s = 0.f, ss = 0.f;
    int h = 0;
    const int t = kTable ? clampi(A.tid[c], 0, A.T - 1) : 0;
    for (int j = 0; j < 2; ++j) {
      const int w = 2 * lane + j;
      if (w >= WF) continue;
      const int n = c * WF + w;
      const int blk = ((int)A.pos[n] / A.IPB) % A.P;
      s.blk[n] = blk;
      if (kTable) {
        const int e = (blk / A.OFFB) % A.E;
        s.idx[n] = e;
        const bool hit = A.tcnt[t * A.E + e] > 0.f;
        i0s += hit ? A.ti0[t * A.E + e] : A.wfi[n];
        ss += hit ? A.tse[t * A.E + e] : A.wfs[n];
        h += hit ? 1 : 0;
      }
    }
    float i0_cu = 0.f, s_cu = 0.f;
    if (kTable) {
      i0_cu = warp_sum(i0s);
      s_cu = warp_sum(ss);
      h = warp_sum_int(h);
      if (lane == 0) s.hits[c] = h;
    }
    if (mech.pred_react) {
      i0_cu = A.ri0[c];
      s_cu = A.rse[c];
    }
    if (lane < NF) {
      const float f = A.F[lane];
      const float capr = cap * f * T * (float)WF;
      const float ip = (i0_cu + s_cu * f) * T;
      s.ipred[c * NF + lane] = fminf(fmaxf(ip, 0.f), capr);
    }
  }
}

// Per-domain select over the A.CU / A.CPD domains of A (warp per domain):
// the first argmin of the Lagrangian cost.
__device__ __forceinline__ void select_freq(const EpochArgs& A,
                                            const Smem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int NF = A.NF, WF = A.WF;
  const float T = A.scal[0], cap = A.scal[2];
  const float w_pbar = A.scal[5], use_rate = A.scal[6], capf = A.scal[7];
  const Pw pw = load_pw(A);
  const int ND = A.CU / A.CPD;
  for (int d = warp; d < ND; d += nwarps) {
    float cost = INFINITY;
    int k = lane;
    const float tac = fmaxf(A.tacc[0], 1e-3f);
    float pbar = 0.f;
    for (int j = 0; j < A.CPD; ++j) pbar += A.eacc[d * A.CPD + j] / tac;
    float I_sum = 0.f, P_dom = 0.f;
    if (lane < NF) {
      const float f = A.F[lane];
      const float capr = cap * f * T * (float)WF;
      for (int j = 0; j < A.CPD; ++j) {
        const float I = s.ipred[(d * A.CPD + j) * NF + lane];
        P_dom += power_of(f, I / capr, pw);
        I_sum += I;
      }
      I_sum = fmaxf(I_sum, 1e-3f);
    }
    const float I_top = __shfl_sync(FULL_MASK, I_sum, NF - 1);
    if (lane < NF) {
      const float denom = use_rate > 0.f ? I_sum : 1.f;
      const float infeasible = I_sum < capf * I_top ? 1.f : 0.f;
      cost = (P_dom + w_pbar * pbar) / denom + 1e9f * infeasible;
    } else {
      k = NF;
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      const float oc = __shfl_xor_sync(FULL_MASK, cost, m);
      const int ok = __shfl_xor_sync(FULL_MASK, k, m);
      if (oc < cost || (oc == cost && ok < k)) {
        cost = oc;
        k = ok;
      }
    }
    if (lane == 0) {
      for (int j = 0; j < A.CPD; ++j) {
        s.fidx[d * A.CPD + j] = k;
        s.fsel[d * A.CPD + j] = A.F[k];
      }
    }
  }
}

// Pass A: every execute row's allocation -> the per-CU traffic partials
// of A's CUs, row r of CU c at traf[r * stride + c].
__device__ __forceinline__ void traffic_partials(const EpochArgs& A,
                                                 const Smem& s, float* traf,
                                                 int stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int c = warp; c < A.CU; c += nwarps) {
    for (int r = 0; r <= A.NF; ++r) {
      const bool sel = r == A.NF;
      const Row row = exec_row(A, s, c, sel ? s.fsel[c] : A.F[r],
                               A.lean && !sel, lane);
      const float am = warp_sum(row.a[0] * row.m[0] + row.a[1] * row.m[1]);
      if (lane == 0) traf[r * stride + c] = am;
    }
  }
}

// Each execute row's memory-traffic scale from the partials of n_cu CUs,
// summed in CU order (one thread per row).
__device__ __forceinline__ void traffic_scale(const EpochArgs& A,
                                              const Smem& s, const float* traf,
                                              int stride, int n_cu) {
  if (threadIdx.x <= A.NF) {
    const int r = threadIdx.x;
    float traffic = 0.f;
    for (int c = 0; c < n_cu; ++c) traffic += traf[r * stride + c];
    s.scale[r] = fminf(1.f, A.scal[3] * A.scal[0] / fmaxf(traffic, 1e-6f));
  }
}

// Pass B for A's CUs (warp per CU): steady rows, counters, energy and the
// estimators; writes every per-CU output. A pc row leaves its per-WF
// estimates in s.dem / s.bef (and the outputs) for the table update.
template <int FAM>
__device__ __forceinline__ void execute(const EpochArgs& A, const Smem& s,
                                        const Mech& mech) {
  constexpr bool kTable = FAM != FAM_REACTIVE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int NF = A.NF, WF = A.WF;
  const float T = A.scal[0], cap = A.scal[2], lat = A.scal[8];
  const Pw pw = load_pw(A);
  const float dF = A.F[NF - 1] - A.F[0];
  for (int c = warp; c < A.CU; c += nwarps) {
    float If0 = 0.f, IfL = 0.f;
    for (int r = 0; r < NF; ++r) {
      const Row row = exec_row(A, s, c, A.F[r], A.lean, lane);
      const float sc = s.scale[r];
      float st[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        st[j] = A.lean ? row.a[j] - row.a[j] * row.m[j] * (1.f - sc)
                       : row.a[j] * (1.f - row.m[j] * (1.f - sc));
      }
      const float If = warp_sum(st[0] + st[1]);
      if (r == 0) If0 = If;
      if (r == NF - 1) IfL = If;
      if (r == 0 || r == NF - 1) {
        float* dst = r == 0 ? s.cf0 : s.cfL;
        for (int j = 0; j < 2; ++j) {
          const int w = 2 * lane + j;
          if (w < WF) dst[c * WF + w] = st[j];
        }
      }
    }
    // the selected (executed) row, exact op order
    const float f = s.fsel[c];
    const Row row = exec_row(A, s, c, f, false, lane);
    const float sc = s.scale[NF];
    const float plen = (float)(A.P * A.IPB);
    const float fprev = A.fprev[c];
    const bool trans = f != fprev;
    float st[2], q[2], cf[2], pos[2], com[2];
    float tmin = INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int w = 2 * lane + j;
      const bool ok = w < WF;
      st[j] = row.a[j] * (1.f - row.m[j] * (1.f - sc));
      q[j] = ok ? row.a[j] / fmaxf(row.d[j], 1e-6f) : 0.f;
      cf[j] = ok ? row.sw[j] * f / fmaxf(row.i0w[j] + row.sw[j] * f, 1e-6f)
                 : 0.f;
      pos[j] = ok ? A.pos[c * WF + w] : 0.f;
      if (ok) tmin = fminf(tmin, pos[j] + st[j]);
    }
    const float group_min = warp_min(tmin);
    const float boundary = (floorf(group_min / plen) + 1.f) * plen;
    const float dead = 1.f - lat / T * (trans ? 1.f : 0.f);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      com[j] = fminf(st[j], fmaxf(boundary - pos[j], 0.f)) * dead;
    }
    const float I_actual = warp_sum(st[0] + st[1]);
    const float work = warp_sum(com[0] + com[1]);
    const int fi = s.fidx[c];
    const float I_at = s.ipred[c * NF + fi];
    const float err = fabsf(I_at - I_actual) / fmaxf(I_actual, 1e-3f);
    const float act_w = work / (cap * f * T * (float)WF);
    const float energy = power_of(f, act_w, pw) * T +
                         trans_energy(fprev, f, pw) * (trans ? 1.f : 0.f);
    const float tsens = (IfL - If0) / (dF * T);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int w = 2 * lane + j;
      if (w < WF) A.pos_o[c * WF + w] = pos[j] + com[j];
    }
    if (kTable && mech.pc_est != EST_NONE) {
      float i0w[2], sw[2];
      if (mech.pc_est == 1) {  // accpc: exact per-WF linear model (forks)
        for (int j = 0; j < 2; ++j) {
          const int w = 2 * lane + j;
          const float c0 = w < WF ? s.cf0[c * WF + w] : 0.f;
          const float cL = w < WF ? s.cfL[c * WF + w] : 0.f;
          const float sv = (cL - c0) / dF;
          sw[j] = sv / T;
          i0w[j] = (c0 - sv * A.F[0]) / T;
        }
      } else {  // pcstall: counter-driven STALL model
        const float q_cu = fmaxf(warp_sum(q[0] + q[1]) / (float)WF, 0.05f);
        for (int j = 0; j < 2; ++j) {
          const float cfq = rintf(cf[j] * 16.f) / 16.f;
          const float dm = st[j] / q_cu;
          const float sv = dm * cfq / f;
          sw[j] = sv / T;
          i0w[j] = fmaxf(dm - sv * f, 0.f) / T;
        }
      }
      for (int j = 0; j < 2; ++j) {
        const int w = 2 * lane + j;
        if (w < WF) {
          A.wfi_o[c * WF + w] = i0w[j];
          A.wfs_o[c * WF + w] = sw[j];
          s.dem[c * WF + w] = i0w[j];
          s.bef[c * WF + w] = sw[j];
        }
      }
    } else if (kTable) {  // a fork row off the table keeps its WF state
      for (int j = 0; j < 2; ++j) {
        const int w = 2 * lane + j;
        if (w < WF) {
          A.wfi_o[c * WF + w] = A.wfi[c * WF + w];
          A.wfs_o[c * WF + w] = A.wfs[c * WF + w];
        }
      }
    }
    if (mech.react_est == EST_FORK) {  // accreac: exact from the forks
      if (lane == 0) {
        const float s_est = (IfL - If0) / (dF * T);
        A.ri0_o[c] = If0 / T - s_est * A.F[0];
        A.rse_o[c] = s_est;
      }
    } else if (mech.react_est != EST_NONE) {  // counter CU models
      float sens;
      // issue ratios clipped at 0.05, zero past the CU's last WF
      float qc[2];
      for (int j = 0; j < 2; ++j)
        qc[j] = 2 * lane + j < WF ? fmaxf(q[j], 0.05f) : 0.f;
      if (mech.react_est == M_STALL) {
        const float cf_cu = warp_sum(cf[0] + cf[1]) / (float)WF;
        sens = I_actual * cf_cu / f;
      } else if (mech.react_est == M_LEAD || mech.react_est == M_CRIT) {
        const float cf_cu = warp_sum(st[0] * cf[0] + st[1] * cf[1]) /
                            fmaxf(I_actual, 1e-6f);
        if (mech.react_est == M_LEAD) {
          sens = I_actual * cf_cu / f;
        } else {
          const float q_mean = warp_sum(qc[0] + qc[1]) / (float)WF;
          sens = I_actual * cf_cu / (f * fmaxf(q_mean, 0.05f));
        }
      } else {  // crisp
        float v[2];
        for (int j = 0; j < 2; ++j)
          v[j] = 2 * lane + j < WF ? st[j] / qc[j] * cf[j] : 0.f;
        sens = warp_sum(v[0] + v[1]) / f;
      }
      if (lane == 0) {
        A.ri0_o[c] = fmaxf(I_actual - sens * f, 0.f) / T;
        A.rse_o[c] = sens / T;
      }
    } else if (FAM == FAM_FORK && lane == 0) {  // off the reactive ids
      A.ri0_o[c] = A.ri0[c];
      A.rse_o[c] = A.rse[c];
    }
    if (lane == 0) {
      A.fsel_o[c] = f;
      A.eacc_o[c] = A.eacc[c] + energy;
      A.work_o[c] = work;
      A.energy_o[c] = energy;
      A.err_o[c] = err;
      A.fidx_o[c] = fi;
      A.tsens_o[c] = tsens;
    }
  }
}

// One table slot of a row's table update: the epoch's estimates of the
// slot's WFs (each WF's slot in idx, its estimates in i0w / sw), walked CU
// by CU in index order over the CUs mapped to the slot's table, then
// blended. Out-of-range table ids match no table (dropped).
__device__ __forceinline__ void slot_update(const EpochArgs& A, int sl,
                                            const int* idx, const float* i0w,
                                            const float* sw) {
  const int t = sl / A.E, e = sl % A.E;
  float isum = 0.f, ssum = 0.f, cnt = 0.f;
  for (int c = 0; c < A.CU; ++c) {
    if (A.tid[c] != t) continue;
    for (int w = 0; w < A.WF; ++w) {
      const int n = c * A.WF + w;
      if (idx[n] == e) {
        isum += i0w[n];
        ssum += sw[n];
        cnt += 1.f;
      }
    }
  }
  ema_write(A.ti0[sl], A.tse[sl], A.tcnt[sl], isum, ssum, cnt, A.scal[4],
            A.ti0_o + sl, A.tse_o + sl, A.tcnt_o + sl);
}

template <int FAM>
__global__ void __launch_bounds__(kThreads)
epoch_fused_kernel(const EpochArgs G) {
  constexpr bool kTable = FAM != FAM_REACTIVE;
  extern __shared__ float smem[];
  const EpochArgs A = row_args(G, blockIdx.x);
  const Mech mech = row_mech<FAM>(G, blockIdx.x);
  const int N = A.CU * A.WF;
  const Smem s = carve(smem, A.Pp, N, A.CU, A.NF);

  load_program(A, s);
  __syncthreads();
  predict<FAM>(A, s, mech);
  __syncthreads();
  select_freq(A, s);
  __syncthreads();
  traffic_partials(A, s, s.traf, A.CU);
  __syncthreads();
  traffic_scale(A, s, s.traf, A.CU, A.CU);
  __syncthreads();
  execute<FAM>(A, s, mech);
  if (threadIdx.x == 0) A.tacc_o[0] = A.tacc[0] + A.scal[0];
  if (!kTable) return;
  __syncthreads();

  if (mech.pc_est != EST_NONE) {
    for (int sl = threadIdx.x; sl < A.T * A.E; sl += blockDim.x)
      slot_update(A, sl, s.idx, s.dem, s.bef);
  } else {  // a fork row off the table passes it through
    for (int sl = threadIdx.x; sl < A.T * A.E; sl += blockDim.x) {
      A.ti0_o[sl] = A.ti0[sl];
      A.tse_o[sl] = A.tse[sl];
      A.tcnt_o[sl] = A.tcnt[sl];
    }
  }
  if (threadIdx.x == 0) {
    int h = 0;
    for (int c = 0; c < A.CU; ++c) h += s.hits[c];
    A.hit_o[0] = (float)h / (float)N;
  }
}

// ---- K5: the CU-tiled fork epoch ------------------------------------------
// Replaces repro/kernels/epoch_fused.py:_fork_blocked (the Pallas pair
// _fork_blk_a / _fork_blk_b and its jnp epilogue). A row of many CUs does
// not fit one CTA's shared memory (at 1024 program blocks, 40 WFs and 10
// states the monolithic kernel holds 189 CUs at most), so the row is cut
// into blocks of block_cu CUs, one CTA per (block, row):
//   pass A  predict + select for the block's CUs (each V/f domain lies whole
//           in a block, so the select is block-local and exact), then the
//           per-CU traffic partials of the 11 execute rows -> traf scratch;
//   pass B  the same predict + select (recomputed: same code, same bits),
//           the traffic scale of each execute row from ALL the row's
//           partials summed in CU order, then the execute, counters,
//           energy and estimators of the block's CUs; each WF's table slot
//           and each CU's hit count -> idx / hit_cu scratch;
//   epilogue one thread per table slot walks the slot's CUs and WFs in
//           index order (the per-WF estimates pass B wrote to wf_i0/wf_sens)
//           and blends; the row's hit rate and time.
// Every value is computed by the monolithic kernel's own device functions
// in its order, so a row equals its monolithic row bit for bit. No float
// atomics; a row's bits depend neither on its batch nor on launch timing.
// Bound: the same bytes as the monolithic kernel (program, state and table
// in and out) plus the scratch; like it, latency-bound by the per-CU warp
// chains, now spread over CU / block_cu CTAs per row.

__device__ __forceinline__ EpochArgs block_args(const EpochArgs& R, int b) {
  // block b's CUs [b * block_cu, (b + 1) * block_cu) of row args R: every
  // per-CU pointer at the block's first CU and CU set to the block's width;
  // the program, the table, the scratch and the per-row scalars stay whole
  EpochArgs A = R;
  const int c0 = b * R.block_cu;
  const size_t n0 = (size_t)c0 * R.WF;
  A.CU = R.block_cu;
  A.pos += n0; A.eps += n0; A.wfi += n0; A.wfs += n0;
  A.pos_o += n0; A.wfi_o += n0; A.wfs_o += n0;
  A.tid += c0; A.ri0 += c0; A.rse += c0; A.fprev += c0; A.eacc += c0;
  A.ri0_o += c0; A.rse_o += c0; A.fsel_o += c0; A.eacc_o += c0;
  A.work_o += c0; A.energy_o += c0; A.err_o += c0; A.fidx_o += c0;
  A.tsens_o += c0;
  return A;
}

__global__ void __launch_bounds__(kThreads)
fork_blocked_pass_a(const EpochArgs G) {
  extern __shared__ float smem[];
  const EpochArgs R = row_args(G, blockIdx.y);
  const EpochArgs A = block_args(R, blockIdx.x);
  const Mech mech = row_mech<FAM_FORK>(G, blockIdx.y);
  const Smem s = carve(smem, A.Pp, A.CU * A.WF, A.CU, A.NF);
  load_program(A, s);
  __syncthreads();
  predict<FAM_FORK>(A, s, mech);
  __syncthreads();
  select_freq(A, s);
  __syncthreads();
  traffic_partials(A, s, R.traf + blockIdx.x * R.block_cu, R.CU);
}

__global__ void __launch_bounds__(kThreads)
fork_blocked_pass_b(const EpochArgs G) {
  extern __shared__ float smem[];
  const EpochArgs R = row_args(G, blockIdx.y);
  const EpochArgs A = block_args(R, blockIdx.x);
  const Mech mech = row_mech<FAM_FORK>(G, blockIdx.y);
  const int N = A.CU * A.WF;
  const Smem s = carve(smem, A.Pp, N, A.CU, A.NF);
  load_program(A, s);
  __syncthreads();
  predict<FAM_FORK>(A, s, mech);
  __syncthreads();
  select_freq(A, s);
  traffic_scale(A, s, R.traf, R.CU, R.CU);
  __syncthreads();
  execute<FAM_FORK>(A, s, mech);
  const int c0 = blockIdx.x * R.block_cu;
  for (int n = threadIdx.x; n < N; n += blockDim.x)
    R.idx[(size_t)c0 * A.WF + n] = s.idx[n];
  for (int c = threadIdx.x; c < A.CU; c += blockDim.x)
    R.hit_cu[c0 + c] = s.hits[c];
}

__global__ void __launch_bounds__(256)
fork_blocked_epilogue(const EpochArgs G) {
  const EpochArgs A = row_args(G, blockIdx.y);
  const Mech mech = row_mech<FAM_FORK>(G, blockIdx.y);
  const int sl = blockIdx.x * blockDim.x + threadIdx.x;
  if (sl < A.T * A.E) {
    if (mech.pc_est != EST_NONE) {
      slot_update(A, sl, A.idx, A.wfi_o, A.wfs_o);
    } else {  // a fork row off the table passes it through
      A.ti0_o[sl] = A.ti0[sl];
      A.tse_o[sl] = A.tse[sl];
      A.tcnt_o[sl] = A.tcnt[sl];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int h = 0;
    for (int c = 0; c < A.CU; ++c) h += A.hit_cu[c];
    A.hit_o[0] = (float)h / (float)(A.CU * A.WF);
    A.tacc_o[0] = A.tacc[0] + A.scal[0];
  }
}

}  // namespace

extern "C" int epoch_fused_launch(const EpochArgs* args, void* stream) {
  const EpochArgs& A = *args;
  if (A.WF < 1 || A.WF > 64 || A.NF < 2 || A.NF > 32 || A.CU < 1 ||
      A.CU % A.CPD != 0 || A.NF + 1 > kThreads || A.R < 1 ||
      A.family < FAM_PC || A.family > FAM_FORK)
    return (int)cudaErrorInvalidValue;
  if (A.family == FAM_FORK &&
      (A.mech == nullptr || A.n_react < 1 || A.n_react > 8))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = 4 * smem_words(A.Pp, A.CU * A.WF, A.CU, A.NF);
  if (bytes > (size_t)kMaxSmem) return kRowTooWide;
  void (*kernel)(const EpochArgs) =
      A.family == FAM_PC ? epoch_fused_kernel<FAM_PC>
      : A.family == FAM_REACTIVE ? epoch_fused_kernel<FAM_REACTIVE>
                                 : epoch_fused_kernel<FAM_FORK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<A.R, kThreads, bytes, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

// K5: passes A and B over (CU / block_cu, R) CTAs, then the epilogue over
// (ceil(T * E / 256), R) CTAs, in stream order on one stream.
extern "C" int epoch_fused_blocked_launch(const EpochArgs* args,
                                          void* stream) {
  const EpochArgs& A = *args;
  if (A.family != FAM_FORK || A.mech == nullptr || A.n_react < 1 ||
      A.n_react > 8 || !A.lean || A.WF < 1 || A.WF > 64 || A.NF < 2 ||
      A.NF > 32 || A.R < 1 || A.R > 65535 || A.block_cu < 1 ||
      A.CU % A.block_cu != 0 || A.block_cu % A.CPD != 0 ||
      A.traf == nullptr || A.hit_cu == nullptr || A.idx == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t bytes =
      4 * smem_words(A.Pp, A.block_cu * A.WF, A.block_cu, A.NF);
  if (bytes > (size_t)kMaxSmem) return kRowTooWide;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      fork_blocked_pass_a, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fork_blocked_pass_b,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(A.CU / A.block_cu, A.R);
  fork_blocked_pass_a<<<grid, kThreads, bytes, st>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fork_blocked_pass_b<<<grid, kThreads, bytes, st>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 egrid((A.T * A.E + 255) / 256, A.R);
  fork_blocked_epilogue<<<egrid, 256, 0, st>>>(A);
  return (int)cudaGetLastError();
}
