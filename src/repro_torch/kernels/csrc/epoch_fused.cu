// The fused fork--execute epoch for Hopper (sm_90a): the specialised
// families "pc" and "reactive" (K3), the traced-mechanism-id family "fork"
// (K4, and K5: the same kernels where the caller names the reference's CU
// tiling), both math modes.
//
// Replaces repro/kernels/epoch_fused.py:epoch_fused (body _epoch_kernel ->
// _epoch_math) and :_fork_blocked (the Pallas pair _fork_blk_a /
// _fork_blk_b and its jnp epilogue): K3 for the specialised run_sim
// families, K4/K5 for the batched sweep, where one call steps every grid
// row of a family. One epoch:
//   context gathers -> predict (PC table or reactive state) -> per-domain
//   argmin select -> execute -> oldest-first WF allocation -> global
//   memory-traffic scale -> barrier / committed counters, transition dead
//   time, energy -> estimator -> table update with hit rate.
//
// Bound on this card: at 64 CUs x 40 WFs x 10 states an epoch reads and
// writes ~0.3 MB per row (the 64 x 128 x 3 table in and out dominates) and
// does ~0.3 MFLOP, so the card could finish it in well under 1 us; the
// kernels are latency-bound: chains of dependent shared-memory gathers,
// IEEE divisions and warp reductions per CU. The design spreads those
// chains over the card and shortens them:
//
// Which execute rows matter. The reference executes NF fork rows (one per
// ladder state) and the selected row, and each row's memory-traffic scale
// is that row's own total over the CUs. The outputs read the selected row
// and fork rows 0 and NF-1 only (the fork-exact estimators, true_sens, the
// per-WF linear model); fork rows 1..NF-2 set nothing but their own scale.
// So three rows per CU are executed, and every output keeps its bits.
//
// One tiled form for every family, over one chain of device functions: a
// row's CUs in CTAs of cta_cu CUs (a divisor of CU, each V/f domain whole
// in a CTA), picked by the launcher from CU, R and the card's SM count
// (the reference's block_cu is checked by the wrapper and picks nothing),
// over three kernels in stream order:
//   pass A   context, predict and select for the CTA's CUs, then the
//            three rows' per-CU traffic partials; f_sel and fidx go to the
//            outputs, I at the selected state, the table hits and each
//            WF's slot to scratch;
//   pass B   each row's traffic scale from ALL the row's partials, summed
//            in CU order; fork rows 0 and NF-1, then the selected row's
//            counters, energy and estimators, reading what pass A
//            selected (no second predict or select);
//   epilogue one warp per table: the table's CUs found by a ballot over
//            tid, their WFs walked in (CU, WF) order into the slots' sums,
//            the EMA blend; the hit rate. Not launched for the reactive
//            family, which has no table.
// Inside a CTA one warp takes one (CU, execute row), two adjacent WFs per
// lane (WF <= 64); rows are looped, never materialised. Every reduction
// stays in one warp in a fixed lane order, every sum across CUs runs in
// CU order and no float atomics are used, so a row's bits depend neither
// on its batch, nor on its tiling, nor on launch timing:
//   * lean fork rows take their intra-CU prefix sum as a warp scan (the
//     reference's tril GEMM); the selected row, and every row in exact
//     mode, sums sequentially in WF order like the reference's cumsum
//     (each lane runs the chain on values broadcast by shuffles);
//   * the argmin takes the first minimum; the quantised core fraction
//     rounds half to even (rintf); int casts truncate;
//   * a table slot sums the epoch's estimates of its WFs in (CU, WF) order
//     over the CUs mapped to its table: out-of-range table ids match no
//     table (dropped), while lookups clamp them;
//   * the family is a template parameter, so the specialised instantiations
//     carry none of the fork family's per-row mechanism logic. In the fork
//     family a row's traced id picks its predictor (reactive ids predict
//     from the CU state, the others from the table), its reactive
//     estimator (counter models in id order, the fork-exact one last) and
//     whether the table and per-WF state advance (pc ids only; a reactive
//     row copies the table through). The hit rate is written for every id.
#include "common.cuh"

namespace {

constexpr int kTileThreads = 256;  // passes A and B
constexpr int kEpiThreads = 256;   // the epilogue: one warp per table
constexpr int kMaxSmem = 232448;  // 227 KB: a CTA's share of an H100 SM
// returned, before any launch, when a CTA's shared memory cannot hold the
// program and the row's traffic partials; not a cudaError_t
constexpr int kRowTooWide = -1;
// the widest CTA the launcher picks: its 3 x 8 execute rows are 24 warp
// tasks for 8 warps
constexpr int kMaxCtaCu = 8;

enum { FAM_PC = 0, FAM_REACTIVE = 1, FAM_FORK = 2 };
// estimator of a row: the counter CU models, the fork-exact model, none
enum { M_STALL = 0, M_LEAD = 1, M_CRIT = 2, M_CRISP = 3, EST_FORK = 4,
       EST_NONE = -1 };
// the execute rows the outputs read: fork rows 0 and NF-1, the selected
enum { ROW_LO = 0, ROW_HI = 1, ROW_SEL = 2, N_ROWS = 3 };

}  // namespace

// Field order mirrors repro_torch/kernels/epoch_fused.py:_EpochArgs.
// Every per-row operand is contiguous with a leading row axis of R rows
// (R = 1 for run_sim); the programs are a stack of W padded programs
// (Pp blocks each) that row r reads through prow[r] (null: program 0),
// with its logical block count Prow[r] (null: P). The shared table map
// tid is one (CU,) vector. Fork rows read their traced id from mech[r];
// n_react ids predict reactively, react_models packs the counter model of
// ids 0..n_react-2 four bits each, pc_mask flags the table-maintaining ids
// and id_ctr_pc is the counter-driven one among them. The tiled form hands
// scratch from kernel to kernel, per row: (3, CU) traffic partials traf,
// (CU) hit counts hit_cu, each WF's table slot idx (CU, WF) and (CU) I at
// the selected state iat; cta_cu is the launcher's CTA width.
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
  float* traf; int* hit_cu; int* idx; float* iat;
  int cta_cu;
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
  ROW_OFF(traf, N_ROWS * C); ROW_OFF(hit_cu, C); ROW_OFF(idx, N);
  ROW_OFF(iat, C);
#undef ROW_OFF
  return A;
}

// CTA b's CUs [b * cta_cu, (b + 1) * cta_cu) of row args R: every per-CU
// pointer at the CTA's first CU and CU set to its width; the program, the
// table, the scratch and the per-row scalars stay whole.
__device__ __forceinline__ EpochArgs cta_args(const EpochArgs& R, int b) {
  EpochArgs A = R;
  const int c0 = b * R.cta_cu;
  const size_t n0 = (size_t)c0 * R.WF;
  A.CU = R.cta_cu;
  A.pos += n0; A.eps += n0; A.pos_o += n0;
  if (A.wfi) { A.wfi += n0; A.wfs += n0; A.wfi_o += n0; A.wfs_o += n0; }
  if (A.tid) A.tid += c0;
  if (A.ri0) { A.ri0 += c0; A.rse += c0; A.ri0_o += c0; A.rse_o += c0; }
  A.fprev += c0; A.eacc += c0;
  A.fsel_o += c0; A.eacc_o += c0; A.work_o += c0; A.energy_o += c0;
  A.err_o += c0; A.fidx_o += c0; A.tsens_o += c0;
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
  int* blk;          // (N) starting PC block
  int* idx;          // (N) table slot
  float *cf0, *cfL;  // (N) steady values of fork rows 0 and NF-1
  float* ipred;      // (CU, NF)
  int* fidx;         // (CU)
  float* fsel;       // (CU)
  float* iat;        // (CU) predicted I at the selected state
  int* hits;         // (CU)
  float *If0, *IfL;  // (CU) fork totals of rows 0 and NF-1
  float* traf;       // (3, n_traf) per-CU traffic partials
  float* scale;      // (3)
};

__host__ __device__ inline size_t smem_words(int Pp, int N, int CU, int NF,
                                             int n_traf) {
  return (size_t)2 * Pp + (size_t)3 * (2 * Pp + 1) + (size_t)4 * N +
         (size_t)CU * NF + (size_t)6 * CU + (size_t)N_ROWS * n_traf + N_ROWS;
}

__device__ Smem carve(float* base, int Pp, int N, int CU, int NF,
                      int n_traf) {
  Smem s;
  const int L = 2 * Pp + 1;
  s.i0r = base; s.sr = s.i0r + Pp;
  s.c0 = s.sr + Pp; s.c1 = s.c0 + L; s.c2 = s.c1 + L;
  s.blk = (int*)(s.c2 + L); s.idx = s.blk + N;
  s.cf0 = (float*)(s.idx + N); s.cfL = s.cf0 + N;
  s.ipred = s.cfL + N;
  s.fidx = (int*)(s.ipred + CU * NF); s.fsel = (float*)(s.fidx + CU);
  s.iat = s.fsel + CU; s.hits = (int*)(s.iat + CU);
  s.If0 = (float*)(s.hits + CU); s.IfL = s.If0 + CU;
  s.traf = s.IfL + CU; s.scale = s.traf + N_ROWS * n_traf;
  return s;
}

__device__ __forceinline__ int wf_block(const EpochArgs& A, int n) {
  return ((int)A.pos[n] / A.IPB) % A.P;
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
  float b[2] = {0.f, 0.f};
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
    // sequential cumsum in WF order (the reference's op order): every lane
    // runs the same chain on the demands broadcast from their lanes and
    // keeps the "before" of its own WFs
    float acc = 0.f;
    for (int p = 0; 2 * p < A.WF; ++p) {
      const float d0 = __shfl_sync(FULL_MASK, r.d[0], p);
      const float d1 = __shfl_sync(FULL_MASK, r.d[1], p);
      acc = acc + d0;
      const float b0 = acc - d0;
      float b1 = 0.f;
      if (2 * p + 1 < A.WF) {
        acc = acc + d1;
        b1 = acc - d1;
      }
      if (lane == p) {
        b[0] = b0;
        b[1] = b1;
      }
    }
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

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// The program rates and the three cum_t rows into shared memory, as
// asynchronous copies that run while predict and select do (neither reads
// the program); program_ready() and a barrier before it is read.
__device__ __forceinline__ void load_program(const EpochArgs& A,
                                             const Smem& s) {
  for (int i = threadIdx.x; i < A.Pp; i += blockDim.x) {
    copy_async(s.i0r + i, A.i0r + i);
    copy_async(s.sr + i, A.sr + i);
  }
  const int L = 2 * A.Pp + 1;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    copy_async(s.c0 + i, A.cum_t + i);
    copy_async(s.c1 + i, A.cum_t + L + i);
    copy_async(s.c2 + i, A.cum_t + 2 * L + i);
  }
}

__device__ __forceinline__ void program_ready() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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
      const int blk = wf_block(A, n);
      s.blk[n] = blk;
      if (kTable) {
        const int e = (blk / A.OFFB) % A.E;
        s.idx[n] = e;
        // both sides of each select loaded at once: one trip to memory
        const float cnt = A.tcnt[t * A.E + e], ti = A.ti0[t * A.E + e];
        const float ts = A.tse[t * A.E + e], fi = A.wfi[n], fs = A.wfs[n];
        const bool hit = cnt > 0.f;
        i0s += hit ? ti : fi;
        ss += hit ? ts : fs;
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
// the first argmin of the Lagrangian cost; each CU's state, frequency and
// predicted rate there.
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
        const int c = d * A.CPD + j;
        s.fidx[c] = k;
        s.fsel[c] = A.F[k];
        s.iat[c] = s.ipred[c * NF + k];
      }
    }
  }
}

// The ladder state of fork row ROW_LO / ROW_HI.
__device__ __forceinline__ float fork_freq(const EpochArgs& A, int k) {
  return A.F[k == ROW_HI ? A.NF - 1 : 0];
}

// The three rows' allocation -> per-CU traffic partials of A's CUs, row k
// of CU c at traf[k * stride + c] (warp per (CU, row), selected rows
// first: they take the longest).
__device__ __forceinline__ void traffic_partials(const EpochArgs& A,
                                                 const Smem& s, float* traf,
                                                 int stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = warp; t < N_ROWS * A.CU; t += nwarps) {
    const int k = ROW_SEL - t / A.CU, c = t % A.CU;
    const bool sel = k == ROW_SEL;
    const Row row = exec_row(A, s, c, sel ? s.fsel[c] : fork_freq(A, k),
                             A.lean && !sel, lane);
    const float am = warp_sum(row.a[0] * row.m[0] + row.a[1] * row.m[1]);
    if (lane == 0) traf[k * stride + c] = am;
  }
}

// Each row's memory-traffic scale from the partials of n_cu CUs, summed
// in CU order (one thread per row).
__device__ __forceinline__ void traffic_scale(const EpochArgs& A,
                                              const Smem& s, const float* traf,
                                              int stride, int n_cu) {
  if (threadIdx.x < N_ROWS) {
    const int k = threadIdx.x;
    float traffic = 0.f;
    for (int c = 0; c < n_cu; ++c) traffic += traf[k * stride + c];
    s.scale[k] = fminf(1.f, A.scal[3] * A.scal[0] / fmaxf(traffic, 1e-6f));
  }
}

// Fork rows 0 and NF-1 of A's CUs (warp per (CU, row)): each WF's steady
// value and the CU's total, for the estimators of the selected row.
__device__ __forceinline__ void fork_rows(const EpochArgs& A, const Smem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = warp; t < 2 * A.CU; t += nwarps) {
    const int k = t / A.CU, c = t % A.CU;
    const Row row = exec_row(A, s, c, fork_freq(A, k), A.lean, lane);
    const float sc = s.scale[k];
    float st[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      st[j] = A.lean ? row.a[j] - row.a[j] * row.m[j] * (1.f - sc)
                     : row.a[j] * (1.f - row.m[j] * (1.f - sc));
    }
    const float If = warp_sum(st[0] + st[1]);
    float* dst = k == ROW_HI ? s.cfL : s.cf0;
    for (int j = 0; j < 2; ++j) {
      const int w = 2 * lane + j;
      if (w < A.WF) dst[c * A.WF + w] = st[j];
    }
    if (lane == 0) (k == ROW_HI ? s.IfL : s.If0)[c] = If;
  }
}

// The selected (executed) row of A's CUs (warp per CU), exact op order:
// counters, energy and the estimators; writes every per-CU output and the
// per-WF state.
template <int FAM>
__device__ __forceinline__ void select_rows(const EpochArgs& A,
                                            const Smem& s, const Mech& mech) {
  constexpr bool kTable = FAM != FAM_REACTIVE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int WF = A.WF;
  const float T = A.scal[0], cap = A.scal[2], lat = A.scal[8];
  const Pw pw = load_pw(A);
  const float dF = A.F[A.NF - 1] - A.F[0];
  for (int c = warp; c < A.CU; c += nwarps) {
    const float If0 = s.If0[c], IfL = s.IfL[c];
    const float f = s.fsel[c];
    const Row row = exec_row(A, s, c, f, false, lane);
    const float sc = s.scale[ROW_SEL];
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
    const float I_at = s.iat[c];
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
      A.fidx_o[c] = s.fidx[c];
      A.tsens_o[c] = tsens;
    }
  }
}

// Table t of a row's update (one warp): the epoch's estimates of the WFs
// of the table's CUs (each WF's slot in idx, its estimates in i0w / sw),
// CU by CU in index order (the CUs found 32 at a time by a ballot over
// tid), WF by WF, each into its slot's sums, owned by lane slot % 32 in
// acc (3 x E floats of this warp's shared memory); then every slot of the
// table blended. A row off the table copies it through. Out-of-range table
// ids match no table (dropped).
__device__ void table_slots(const EpochArgs& A, const Mech& mech, int t,
                            const int* idx, const float* i0w,
                            const float* sw, float* acc) {
  const int lane = threadIdx.x & 31, E = A.E;
  const size_t base = (size_t)t * E;
  if (mech.pc_est == EST_NONE) {
    for (int e = lane; e < E; e += 32) {
      A.ti0_o[base + e] = A.ti0[base + e];
      A.tse_o[base + e] = A.tse[base + e];
      A.tcnt_o[base + e] = A.tcnt[base + e];
    }
    return;
  }
  float *ai = acc, *as = acc + E, *ac = acc + 2 * E;
  for (int e = lane; e < E; e += 32) ai[e] = as[e] = ac[e] = 0.f;
  __syncwarp();
  for (int c0 = 0; c0 < A.CU; c0 += 32) {
    unsigned mine = __ballot_sync(
        FULL_MASK, c0 + lane < A.CU && A.tid[c0 + lane] == t);
    while (mine) {
      const int c = c0 + __ffs(mine) - 1;
      mine &= mine - 1;
      for (int w0 = 0; w0 < A.WF; w0 += 32) {
        const int w = w0 + lane;
        const size_t n = (size_t)c * A.WF + w;
        int e = 0;
        float vi = 0.f, vs = 0.f;
        if (w < A.WF) {
          e = idx[n];
          vi = i0w[n];
          vs = sw[n];
        }
        const int nw = min(32, A.WF - w0);
        for (int j = 0; j < nw; ++j) {
          const int ej = __shfl_sync(FULL_MASK, e, j);
          const float ij = __shfl_sync(FULL_MASK, vi, j);
          const float sj = __shfl_sync(FULL_MASK, vs, j);
          if ((ej & 31) == lane) {
            ai[ej] += ij;
            as[ej] += sj;
            ac[ej] += 1.f;
          }
        }
      }
    }
  }
  __syncwarp();
  for (int e = lane; e < E; e += 32)
    ema_write(A.ti0[base + e], A.tse[base + e], A.tcnt[base + e], ai[e],
              as[e], ac[e], A.scal[4], A.ti0_o + base + e,
              A.tse_o + base + e, A.tcnt_o + base + e);
}

// The row's table hit rate from its per-CU hit counts (one warp).
__device__ __forceinline__ void hit_rate(const EpochArgs& A, const int* hits) {
  const int lane = threadIdx.x & 31;
  int h = 0;
  for (int c = lane; c < A.CU; c += 32) h += hits[c];
  h = warp_sum_int(h);
  if (lane == 0) A.hit_o[0] = (float)h / (float)(A.CU * A.WF);
}

// ---- the kernels -------------------------------------------------------------

template <int FAM>
__global__ void __launch_bounds__(kTileThreads)
epoch_pass_a(const EpochArgs G) {
  constexpr bool kTable = FAM != FAM_REACTIVE;
  extern __shared__ float smem[];
  const EpochArgs R = row_args(G, blockIdx.y);
  const EpochArgs A = cta_args(R, blockIdx.x);
  const Mech mech = row_mech<FAM>(G, blockIdx.y);
  const int N = A.CU * A.WF, c0 = blockIdx.x * R.cta_cu;
  const Smem s = carve(smem, A.Pp, N, A.CU, A.NF, 0);
  load_program(A, s);
  predict<FAM>(A, s, mech);
  __syncthreads();
  select_freq(A, s);
  program_ready();
  __syncthreads();
  // what pass B and the epilogue read
  for (int c = threadIdx.x; c < A.CU; c += blockDim.x) {
    A.fsel_o[c] = s.fsel[c];
    A.fidx_o[c] = s.fidx[c];
    R.iat[c0 + c] = s.iat[c];
    if (kTable) R.hit_cu[c0 + c] = s.hits[c];
  }
  if (kTable)
    for (int n = threadIdx.x; n < N; n += blockDim.x)
      R.idx[(size_t)c0 * A.WF + n] = s.idx[n];
  traffic_partials(A, s, R.traf + c0, R.CU);
}

template <int FAM>
__global__ void __launch_bounds__(kTileThreads)
epoch_pass_b(const EpochArgs G) {
  extern __shared__ float smem[];
  const EpochArgs R = row_args(G, blockIdx.y);
  const EpochArgs A = cta_args(R, blockIdx.x);
  const Mech mech = row_mech<FAM>(G, blockIdx.y);
  const int N = A.CU * A.WF, c0 = blockIdx.x * R.cta_cu;
  const Smem s = carve(smem, A.Pp, N, A.CU, A.NF, R.CU);
  load_program(A, s);
  for (int n = threadIdx.x; n < N; n += blockDim.x) s.blk[n] = wf_block(A, n);
  for (int c = threadIdx.x; c < A.CU; c += blockDim.x) {
    s.fsel[c] = A.fsel_o[c];
    s.fidx[c] = A.fidx_o[c];
    s.iat[c] = R.iat[c0 + c];
  }
  for (int i = threadIdx.x; i < N_ROWS * R.CU; i += blockDim.x)
    s.traf[i] = R.traf[i];
  __syncthreads();
  traffic_scale(A, s, s.traf, R.CU, R.CU);
  program_ready();
  __syncthreads();
  fork_rows(A, s);
  __syncthreads();
  select_rows<FAM>(A, s, mech);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    A.tacc_o[0] = A.tacc[0] + A.scal[0];
}

template <int FAM>
__global__ void __launch_bounds__(kEpiThreads)
epoch_epilogue(const EpochArgs G) {
  extern __shared__ float smem[];
  const EpochArgs A = row_args(G, blockIdx.y);
  const Mech mech = row_mech<FAM>(G, blockIdx.y);
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * (blockDim.x >> 5) + warp;
  if (t < A.T)
    table_slots(A, mech, t, A.idx, A.wfi_o, A.wfs_o,
                smem + (size_t)3 * A.E * warp);
  if (blockIdx.x == 0 && warp == 0) hit_rate(A, A.hit_cu);
}

// The CTA width: the widest divisor of CU that holds
// whole domains, is at most kMaxCtaCu and still gives every SM of the card
// a CTA over the R rows; where none does, the narrowest.
int cta_width(int CU, int R, int CPD) {
  int sms = sm_count();
  if (!sms) sms = 132;
  int best = 0, least = 0;
  for (int w = CPD; w <= CU; w += CPD) {
    if (CU % w) continue;
    if (!least) least = w;
    if (w <= kMaxCtaCu && (long long)R * (CU / w) >= sms) best = w;
  }
  return best ? best : least;
}

template <int FAM>
int launch_tiled(const EpochArgs& A, cudaStream_t st) {
  const size_t pass =
      4 * smem_words(A.Pp, A.cta_cu * A.WF, A.cta_cu, A.NF, A.CU);
  const size_t epi = FAM == FAM_REACTIVE
                         ? 0
                         : 4 * (size_t)3 * A.E * (kEpiThreads / 32);
  const size_t bytes = pass > epi ? pass : epi;
  if (bytes > (size_t)kMaxSmem) return kRowTooWide;
  cudaError_t err = cudaFuncSetAttribute(
      epoch_pass_a<FAM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pass);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(epoch_pass_b<FAM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)pass);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(A.CU / A.cta_cu, A.R);
  epoch_pass_a<FAM><<<grid, kTileThreads, pass, st>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  epoch_pass_b<FAM><<<grid, kTileThreads, pass, st>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (FAM != FAM_REACTIVE) {
    err = cudaFuncSetAttribute(epoch_epilogue<FAM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)epi);
    if (err != cudaSuccess) return (int)err;
    constexpr int kWarps = kEpiThreads / 32;
    const dim3 egrid((A.T + kWarps - 1) / kWarps, A.R);
    epoch_epilogue<FAM><<<egrid, kEpiThreads, epi, st>>>(A);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

// Every family: passes A and B over (CU / cta_cu, R) CTAs, then (pc and
// fork) the epilogue over (ceil(T / 8), R) CTAs, in stream order on one
// stream. The launcher picks cta_cu.
extern "C" int epoch_fused_launch(const EpochArgs* args, void* stream) {
  EpochArgs A = *args;
  if (A.WF < 1 || A.WF > 64 || A.NF < 2 || A.NF > 32 || A.CU < 1 ||
      A.CPD < 1 || A.CU % A.CPD != 0 || A.R < 1 || A.R > 65535 ||
      A.family < FAM_PC || A.family > FAM_FORK || A.traf == nullptr ||
      A.iat == nullptr ||
      (A.family != FAM_REACTIVE && (A.hit_cu == nullptr || A.idx == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (A.family == FAM_FORK &&
      (A.mech == nullptr || A.n_react < 1 || A.n_react > 8))
    return (int)cudaErrorInvalidValue;
  A.cta_cu = cta_width(A.CU, A.R, A.CPD);
  const cudaStream_t st = (cudaStream_t)stream;
  if (A.family == FAM_PC) return launch_tiled<FAM_PC>(A, st);
  if (A.family == FAM_REACTIVE) return launch_tiled<FAM_REACTIVE>(A, st);
  return launch_tiled<FAM_FORK>(A, st);
}

// The CTA width the launcher picks for R rows of CU CUs in domains of CPD
// CUs (on the current device), or 0 where no width holds whole domains.
extern "C" int epoch_fused_cta_width(int CU, int R, int CPD) {
  if (CU < 1 || R < 1 || CPD < 1 || CU % CPD) return 0;
  return cta_width(CU, R, CPD);
}
