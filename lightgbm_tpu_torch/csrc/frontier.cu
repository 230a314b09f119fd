// Frontier-batched tree growth on Hopper: the bookkeeping of a step that
// splits up to K leaves, the tree-start positions and the tree-end undo
// of the rows, and the conditional graph nodes that skip a stopped
// tree's steps.
//
// No TPU kernel corresponds to it: in the JAX package the bookkeeping is
// XLA code in the while-loop body of _build_tree_frontier and
// _renumber_frontier (lightgbm_tpu/models/learner.py).  Its plain PyTorch
// versions are in lightgbm_tpu_torch/ops/frontier.py
// (frontier_step_plain, frontier_key_plain, frontier_undo_plain), and the
// kernels agree with them bit for bit: integer bookkeeping, comparisons
// and f32 copies, with the only conversions int -> f32 of counts below
// 2^24.  ops/frontier.py's module doc gives the replay and the layout.
//
// frontier_step, one block: MODE_ROOT resets the state; MODE_STEP commits
// the step just run (its 2K children's leaf columns and items), runs the
// oracle replay's pops, and selects the next batch -- the required item
// and the K-1 best other candidates -- writing K step records for the
// split kernels, the leaves' snapshots and node columns and the info
// rows of the 2K children; MODE_FINAL renumbers into the K=1 learner's
// leafmat and nodemat and lists the pruned speculative ranges.  The
// elections (the replay's pick, the batch's top K-1) run as
// block-wide reductions; the column copies on all 256 threads.  When a conditional
// handle is given, thread 0 sets it: to "a batch was selected" in
// MODE_STEP (the next step's IF node), to "something was pruned" in
// MODE_FINAL (the undo's IF node).
//
// What bounds it on this card: latency.  A step moves a few leafmat and
// nodemat columns, the step records and the info rows (a few KB) and
// scans the items (2 (L-1) + 2K words a pick) once per pop and per
// pick; its time is the chain of dependent warp reductions.
//
// frontier_key: each row's position in the root range into payload row
// KEY_ROW at the start of a tree (the partition moves it with the row),
// zeros at the end.  frontier_undo: each pruned range's two children
// (left count from the replay) merged by key -- a row's destination is
// its index in its own child plus the rows of the other child that
// precede it (a binary search) -- into the workspace's right-side
// scratch, then copied back.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "step.cuh"
#include "tree_cols.cuh"

#define FR_THREADS 256
#define MODE_ROOT 0
#define MODE_STEP 1
#define MODE_FINAL 2
#define PEND_NONE 0
#define PEND_ROOT 1
#define PEND_SPLIT 2
#define FULL 0xffffffffu
#define BIG_SLOT (1 << 30)
#define ERR_PRUNED 8

// state words (ops/frontier.py FS_*)
#define FS_MADE 0
#define FS_M 1
#define FS_DONE 2
#define FS_UITEM 3
#define FS_PEND 4
#define FS_KSTEP 5
#define FS_RUN 6
#define FS_NPRUNED 7
#define FS_ERR 8
#define FS_STEPS 9
#define FS_HEAD 16

// Offsets of the state arrays (ops/frontier.py layout).
struct Lay {
  int it_gain, it_slot, it_split, it_oslot, avail, sel, pop_split, ora_of,
      slot_item, nl_of, undo, words;
};

__host__ __device__ inline Lay layout(int L, int K) {
  const int MS = (L - 1) + (K - 1), NI = 2 * MS + 2;
  Lay y;
  int o = FS_HEAD;
  y.it_gain = o; o += NI;
  y.it_slot = o; o += NI;
  y.it_split = o; o += NI;
  y.it_oslot = o; o += NI;
  y.avail = o; o += NI;
  y.sel = o; o += K;
  y.pop_split = o; o += L;
  y.ora_of = o; o += MS + 1;
  y.slot_item = o; o += L + 1;
  y.nl_of = o; o += MS + 1;
  y.undo = o; o += 3 * K;
  y.words = o;
  return y;
}

struct FrArgs {
  int* fs;              // state words
  float* lmw;           // (NLF, MS + 2) working leaf columns
  float* nmw;           // (NND, MS + 1) node columns by split made
  float* snap;          // (NLF, MS + 1) the split leaf's column
  float* lm;            // (NLF, L + 1) out: K=1 leafmat
  float* nm;            // (NND, L) out: K=1 nodemat
  int* steps;           // (K, STEP_WORDS) step records
  const int* nl;        // (K,) left counts of the step just run
  const float* pair;    // (2K, SEG) the pair search's rows
  float* info;          // (2K F, 8) the next search's info rows
  const float* sums;    // (2,) the root histogram's sums
  const int* fmeta;     // (FMETA_ROWS, F)
  const int* bag;       // (1,) the root's bag-aware row count
  const float* fmask;   // (F,) the tree's feature mask (0 / 1)
  int L, K, F, row0, N, mode;
  // set to the step's outcome when nonzero (inside a captured graph):
  // the IF nodes of the next step and of the block that step opens
  // (MODE_STEP), or the undo's (MODE_FINAL)
  cudaGraphConditionalHandle handle, handle2;
};

__device__ __forceinline__ void set_handles(const FrArgs& a, unsigned v) {
  if (a.handle) cudaGraphSetConditional(a.handle, v);
  if (a.handle2) cudaGraphSetConditional(a.handle2, v);
}

// The initial value of state word i (MODE_ROOT).
__device__ __forceinline__ int init_word(int i, const Lay& y) {
  if (i == FS_PEND) return PEND_ROOT;
  if (i >= y.it_gain && i < y.it_slot)
    return __float_as_int(-INFINITY);
  if (i >= y.it_split && i < y.it_oslot) return -1;
  if (i >= y.it_oslot && i < y.avail) return i == y.it_oslot ? 0 : BIG_SLOT;
  if (i >= y.avail && i < y.sel) return i == y.avail ? 1 : 0;
  if (i >= y.pop_split && i < y.ora_of) return -1;
  if (i >= y.ora_of && i < y.slot_item) return -1;
  if (i >= y.slot_item && i < y.nl_of) return i == y.slot_item ? 0 : -1;
  return 0;
}

// NaN-propagating maximum (jnp.max / torch.max).
__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a) || isnan(b)) return NAN;
  return fmaxf(a, b);
}

// The item arrays a step's elections read, staged in shared memory.
struct Items {
  float* gain;
  int *avail, *oslot, *split, *slot;
  int *sel, *sel_slot;      // the batch: K items and their leaf slots
  unsigned char* taken;
};

// A candidate of an election: its value, its oracle slot (the replay's
// pick only) and its item; item -1 is none.
struct Cand {
  float v;
  int slot, idx;
};

#define NWARPS (FR_THREADS / 32)

// The replay's order: the larger gain, then the smaller oracle slot, then
// the smaller item (NaNs are flagged apart, see oracle_pick).
__device__ __forceinline__ bool pick_before(const Cand& a, const Cand& b) {
  if (a.idx < 0) return false;
  if (b.idx < 0) return true;
  if (a.v != b.v) return a.v > b.v;
  if (a.slot != b.slot) return a.slot < b.slot;
  return a.idx < b.idx;
}

// The batch's order: NaN first, the larger score, the smaller item.
__device__ __forceinline__ bool topk_before(const Cand& a, const Cand& b) {
  if (a.idx < 0) return false;
  if (b.idx < 0) return true;
  return before(a.v, a.idx, b.v, b.idx);
}

__device__ __forceinline__ Cand shfl_cand(const Cand& c, int m) {
  return {__shfl_xor_sync(FULL, c.v, m), __shfl_xor_sync(FULL, c.slot, m),
          __shfl_xor_sync(FULL, c.idx, m)};
}

// The block's best candidate by `ord`, in every thread; `flag` ORed over
// the block too.  Two barriers; s_c (NWARPS + 1) and s_f (NWARPS + 1)
// are shared scratch.
template <typename Ord>
__device__ Cand block_best(Cand c, int* flag, Cand* s_c, int* s_f, Ord ord) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int f = *flag;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const Cand o = shfl_cand(c, m);
    if (ord(o, c)) c = o;
    f |= __shfl_xor_sync(FULL, f, m);
  }
  if (lane == 0) {
    s_c[warp] = c;
    s_f[warp] = f;
  }
  __syncthreads();
  if (warp == 0) {
    Cand w = lane < NWARPS ? s_c[lane] : Cand{0.0f, 0, -1};
    int g = lane < NWARPS ? s_f[lane] : 0;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      const Cand o = shfl_cand(w, m);
      if (ord(o, w)) w = o;
      g |= __shfl_xor_sync(FULL, g, m);
    }
    if (lane == 0) {
      s_c[NWARPS] = w;
      s_f[NWARPS] = g;
    }
  }
  __syncthreads();
  *flag = s_f[NWARPS];
  return s_c[NWARPS];
}

// The K=1 learner's next-leaf election over items [0, n) on the block
// (ops/split.py oracle_next_pick; no item at or past n is available): the
// largest available gain, ties to the smallest oracle slot, then the
// smallest item.  A NaN among the available gains makes the gain NaN and
// the item 0 (no item ties a NaN maximum); with nothing available the
// gain is -inf and the item 0.  Every thread returns the same.
__device__ void oracle_pick(const Items& it, int n, int* item_out,
                            float* gmax_out, Cand* s_c, int* s_f) {
  Cand c{0.0f, 0, -1};
  int nan_seen = 0;
  for (int i = threadIdx.x; i < n; i += FR_THREADS) {
    if (!it.avail[i]) continue;
    const Cand o{it.gain[i], it.oslot[i], i};
    nan_seen |= isnan(o.v);
    if (pick_before(o, c)) c = o;
  }
  c = block_best(c, &nan_seen, s_c, s_f, pick_before);
  if (nan_seen) {
    *item_out = 0;
    *gmax_out = NAN;
  } else {
    *item_out = c.idx < 0 ? 0 : c.idx;
    *gmax_out = c.idx < 0 ? -INFINITY : c.v;
  }
}

// The replay's pops on the block (JAX sim_body): until the queue stalls on
// an item not split yet (the next required item), the budget is spent
// or no gain is > 0.  Items [0, n) hold every item made so far.  The
// split count m, the required item and the stop flag stay in registers
// until the last pop.
__device__ void replay(int* fs, const Lay& y, const Items& it, int L, int n,
                       Cand* s_c, int* s_f) {
  int m = fs[FS_M], uitem = fs[FS_UITEM], done = fs[FS_DONE];
  while (true) {
    int item;
    float gmax;
    oracle_pick(it, n, &item, &gmax, s_c, s_f);
    const bool budget_done = m >= L - 1;
    const bool dead = !(gmax > 0.0f);
    const int j2 = it.split[item];
    if (!budget_done && !dead && j2 < 0) uitem = item;
    if (budget_done || dead) done = 1;
    if (budget_done || dead || j2 < 0) break;
    if (threadIdx.x == 0) {
      const int cl = 1 + 2 * j2, cr = cl + 1, po = it.oslot[item];
      it.avail[item] = 0;
      it.avail[cl] = 1;
      it.avail[cr] = 1;
      it.oslot[cl] = po;
      it.oslot[cr] = m + 1;
      fs[y.slot_item + po] = cl;
      fs[y.slot_item + m + 1] = cr;
      fs[y.pop_split + m] = j2;
      fs[y.ora_of + j2] = m;
    }
    ++m;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    fs[FS_M] = m;
    fs[FS_UITEM] = uitem;
    fs[FS_DONE] = done;
  }
}

// The next batch on the block (ops/split.py frontier_topk): the required
// item, then K-1 rounds each electing the best item not yet elected by
// the candidates' scores (NaN first, larger first, smaller index on a
// tie; -inf for a non-candidate and for the required item, which a round
// may elect as such).  Every candidate lies in [0, n), and K-1 rounds
// elect no item past n + K, so the rounds scan [0, min(NI, n + K)).
// Writes the K items and their slots to sel / sel_slot and returns the
// number of finite scores, the required item's counted.
__device__ int select_batch(int* fs, const Lay& y, const Items& it, int req,
                            int n, int NI, int K, Cand* s_c, int* s_f) {
  const int tid = threadIdx.x;
  const int hi = min(NI, n + K);
  for (int i = tid; i < hi; i += FR_THREADS) it.taken[i] = 0;
  if (tid == 0) it.sel[0] = req;
  __syncthreads();
  int ncand = 1;
  for (int r = 1; r < K; ++r) {
    Cand c{0.0f, 0, -1};
    for (int i = tid; i < hi; i += FR_THREADS) {
      if (it.taken[i]) continue;
      const float g = it.gain[i];
      const bool cand = it.avail[i] && it.split[i] < 0 && g > 0.0f;
      const Cand o{(cand && i != req) ? g : -INFINITY, 0, i};
      if (topk_before(o, c)) c = o;
    }
    int unused = 0;
    c = block_best(c, &unused, s_c, s_f, topk_before);
    // [0, hi) holds at least K items, so a round always elects one
    if (tid == 0) {
      it.sel[r] = c.idx;
      it.taken[c.idx] = 1;
    }
    ncand += isfinite(c.v) ? 1 : 0;
    __syncthreads();
  }
  for (int r = tid; r < K; r += FR_THREADS) {
    fs[y.sel + r] = it.sel[r];
    it.sel_slot[r] = it.slot[it.sel[r]];
  }
  __syncthreads();
  return ncand;
}

__global__ void __launch_bounds__(FR_THREADS) frontier_step(FrArgs a) {
  // gain, avail, oslot, split, slot (NI words each), the batch's items and
  // slots (K words each), then NI taken flags
  extern __shared__ int s_items[];
  __shared__ int s_kstep, s_made, s_pend, s_ok, s_m, s_done, s_req;
  __shared__ Cand s_c[NWARPS + 1];
  __shared__ int s_f[NWARPS + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.L, K = a.K, F = a.F;
  const int MS = (L - 1) + (K - 1), SL = MS + 2, NI = 2 * MS + 2;
  const Lay y = layout(L, K);
  int* fs = a.fs;
  float* it_gain = (float*)(fs + y.it_gain);

  if (a.mode == MODE_ROOT) {
    for (int i = tid; i < y.words; i += FR_THREADS) fs[i] = init_word(i, y);
    for (int i = tid; i < NLF * SL; i += FR_THREADS)
      a.lmw[i] = empty_leaf_field(i / SL);
    for (int i = tid; i < NND * (MS + 1); i += FR_THREADS) a.nmw[i] = 0.0f;
    for (int i = tid; i < NLF * (MS + 1); i += FR_THREADS) a.snap[i] = 0.0f;
    const float in[4] = {a.sums[0], a.sums[1], (float)*a.bag, 0.0f};
    for (int i = tid; i < 2 * K * F * 8; i += FR_THREADS) {
      const int c = i / (F * 8), col = i & 7;
      a.info[i] = c != 0 || col > 4 ? 0.0f
                  : col == 4 ? a.fmask[(i >> 3) % F] : in[col];
    }
    for (int i = tid; i < K * STEP_WORDS; i += FR_THREADS) a.steps[i] = 0;
    return;
  }

  if (a.mode == MODE_FINAL) {
    // ---- renumber into the K=1 learner's numbering (JAX
    // _renumber_frontier), a pruned leaf from its snapshot ----------
    const int m = fs[FS_M], made = fs[FS_MADE], L1 = L + 1, nodes = L - 1;
    for (int i = tid; i < NLF * L1; i += FR_THREADS) {
      const int f = i / L1, leaf = i % L1;
      float v = empty_leaf_field(f);
      const int item = (leaf <= m && leaf < L) ? fs[y.slot_item + leaf] : -1;
      if (item >= 0) {
        const int jw = fs[y.it_split + item];
        v = jw >= 0 ? a.snap[f * (MS + 1) + jw]
                    : a.lmw[f * SL + fs[y.it_slot + item]];
        if (f == LM_PARENT)
          v = __int_as_float(item > 0 ? fs[y.ora_of + (item - 1) / 2] : -1);
        if (f == LM_PSIDE) v = __int_as_float(item > 0 ? (item - 1) % 2 : 0);
      }
      a.lm[i] = v;
    }
    for (int i = tid; i < NND * L; i += FR_THREADS) {
      const int f = i / L, node = i % L;
      float v = 0.0f;
      if (node < m && node < nodes) {
        const int j = fs[y.pop_split + node];
        v = a.nmw[f * (MS + 1) + j];
        if (f == ND_LEFT || f == ND_RIGHT) {
          const int c = 1 + 2 * j + (f == ND_RIGHT);
          const int jc = fs[y.it_split + c];
          const int o = jc >= 0 ? fs[y.ora_of + jc] : -1;
          v = __int_as_float(o >= 0 ? o : -(fs[y.it_oslot + c] + 1));
        }
      }
      a.nm[i] = v;
    }
    if (tid == 0) {
      for (int i = 0; i < 3 * K; ++i) fs[y.undo + i] = 0;
      int n = 0;
      for (int j = 0; j < made; ++j) {
        if (fs[y.ora_of + j] >= 0) continue;
        if (n >= K - 1) {
          fs[FS_ERR] |= ERR_PRUNED;
          break;
        }
        fs[y.undo + 3 * n] = __float_as_int(a.snap[LM_START * (MS + 1) + j]);
        fs[y.undo + 3 * n + 1] = __float_as_int(a.snap[LM_CNT * (MS + 1) + j]);
        fs[y.undo + 3 * n + 2] = fs[y.nl_of + j];
        ++n;
      }
      fs[FS_NPRUNED] = n;
      if (fs[FS_PEND] != PEND_NONE) fs[FS_ERR] |= ERR_STEP;
      a.steps[SB_S] = m;
      a.steps[SB_MADE] = made;
      a.steps[SB_STEPS] = fs[FS_STEPS];
      a.steps[SB_ERR] |= fs[FS_ERR];
      set_handles(a, n > 0 ? 1u : 0u);
    }
    return;
  }

  // ---- MODE_STEP: commit what is due ---------------------------------
  if (tid == 0) {
    s_pend = fs[FS_PEND];
    s_kstep = fs[FS_KSTEP];
    s_made = fs[FS_MADE];
  }
  __syncthreads();
  const int pend = s_pend, ks = s_kstep, made0 = s_made;
  if (pend == PEND_ROOT && tid == 0) {
    write_leaf_column(a.lmw, SL, a.row0, a.N, *a.bag, a.sums[0],
                      a.sums[1], 0, 0.0f, -1, 0, a.pair);
    it_gain[0] = a.pair[0];
    fs[FS_DONE] = !(a.pair[0] > 0.0f);
  } else if (pend == PEND_SPLIT) {
    // one thread a child: its leaf column; one thread a split: its items
    for (int t = tid; t < 2 * ks; t += FR_THREADS) {
      const int k = t >> 1, side = t & 1, j = made0 + k;
      const int item = fs[y.sel + k];
      const int slot = fs[y.it_slot + item];
      const float* pc = a.snap + j;
      const int S1 = MS + 1;
      const int start = __float_as_int(pc[LM_START * S1]);
      const int cnt = __float_as_int(pc[LM_CNT * S1]);
      const int depth = __float_as_int(pc[LM_DEPTH * S1]) + 1;
      const int left = a.nl[k];
      if (side == 0)
        write_leaf_column(a.lmw + slot, SL, start, left,
                          __float_as_int(pc[LM_BLCNT * S1]),
                          pc[LM_BLSG * S1], pc[LM_BLSH * S1], depth,
                          pc[LM_BLOUT * S1], j, 0, a.pair + k * SEG);
      else
        write_leaf_column(a.lmw + j + 1, SL, start + left, cnt - left,
                          __float_as_int(pc[LM_BRCNT * S1]),
                          pc[LM_BRSG * S1], pc[LM_BRSH * S1], depth,
                          pc[LM_BROUT * S1], j, 1, a.pair + (K + k) * SEG);
    }
    for (int k = tid; k < ks; k += FR_THREADS) {
      const int j = made0 + k, item = fs[y.sel + k];
      it_gain[1 + 2 * j] = a.pair[k * SEG];
      it_gain[2 + 2 * j] = a.pair[(K + k) * SEG];
      fs[y.it_slot + 1 + 2 * j] = fs[y.it_slot + item];
      fs[y.it_slot + 2 + 2 * j] = j + 1;
      fs[y.nl_of + j] = a.nl[k];
    }
    __syncthreads();
    // it_split after the slots above were read
    for (int k = tid; k < ks; k += FR_THREADS)
      fs[y.it_split + fs[y.sel + k]] = made0 + k;
    if (tid == 0) fs[FS_MADE] = made0 + ks;
  }
  __syncthreads();
  // the elections run on the item arrays staged in shared memory; items
  // past 2 made + 1 were never made (never available, gain -inf)
  const Items it{(float*)s_items,    s_items + NI,     s_items + 2 * NI,
                 s_items + 3 * NI,   s_items + 4 * NI, s_items + 5 * NI,
                 s_items + 5 * NI + K,
                 (unsigned char*)(s_items + 5 * NI + 2 * K)};
  const int n_items = min(NI, 1 + 2 * fs[FS_MADE]);
  const int n_stage = min(NI, n_items + K);
  for (int i = tid; i < n_stage; i += FR_THREADS) {
    it.gain[i] = it_gain[i];
    it.avail[i] = fs[y.avail + i];
    it.oslot[i] = fs[y.it_oslot + i];
    it.split[i] = fs[y.it_split + i];
    it.slot[i] = fs[y.it_slot + i];
  }
  __syncthreads();
  if (pend == PEND_SPLIT) {
    replay(fs, y, it, L, n_items, s_c, s_f);
    __syncthreads();
    for (int i = tid; i < n_items; i += FR_THREADS) {
      fs[y.avail + i] = it.avail[i];
      fs[y.it_oslot + i] = it.oslot[i];
    }
  }
  __syncthreads();
  for (int i = tid; i < K; i += FR_THREADS) {
    a.steps[i * STEP_WORDS + SB_CNT] = 0;
    a.steps[i * STEP_WORDS + SB_VALID] = 0;
  }
  if (tid == 0) {
    fs[FS_PEND] = PEND_NONE;
    fs[FS_KSTEP] = 0;
    fs[FS_RUN] = 0;
  }
  __syncthreads();

  // ---- select the next step's batch ----------------------------------
  if (tid == 0) {
    s_made = fs[FS_MADE];
    s_m = fs[FS_M];
    s_done = fs[FS_DONE];
    s_req = fs[FS_UITEM];
  }
  __syncthreads();
  const int made = s_made, m = s_m, req = s_req;
  if (s_done || made >= MS) {
    if (tid == 0) set_handles(a, 0u);
    return;
  }
  const int ncand = select_batch(fs, y, it, req, n_items, NI, K, s_c, s_f);
  if (warp == 0) {
    const int needed = (L - 1) - m, s_left = MS - made;
    int k = min(min(K, needed), s_left - needed + 1);
    k = max(1, min(min(k, ncand), K));
    // every selected leaf's feature must index fmeta
    bool bad = false;
    for (int q = lane; q < k; q += 32) {
      const int fe = __float_as_int(a.lmw[LM_BFEAT * SL + it.sel_slot[q]]);
      bad = bad || fe < 0 || fe >= F || it.sel[q] == NI - 1;
    }
    bad = __any_sync(FULL, bad);
    if (lane == 0) {
      if (bad) {
        fs[FS_ERR] |= ERR_STEP;
        fs[FS_DONE] = 1;
      }
      s_ok = !bad;
      s_kstep = k;
    }
  }
  __syncthreads();
  if (!s_ok) {
    if (tid == 0) set_handles(a, 0u);
    return;
  }
  const int kstep = s_kstep;
  const int S1 = MS + 1;
  // snapshots and node columns: one thread a (lane, field)
  for (int t = tid; t < kstep * NLF; t += FR_THREADS) {
    const int k = t / NLF, f = t % NLF, j = made + k;
    a.snap[f * S1 + j] = a.lmw[f * SL + it.sel_slot[k]];
  }
  for (int t = tid; t < kstep * NND; t += FR_THREADS) {
    const int k = t / NND, f = t % NND, j = made + k;
    const int slot = it.sel_slot[k];
    const float* pc = a.lmw + slot;
    const int fe = __float_as_int(pc[LM_BFEAT * SL]);
    const int* fm = a.fmeta + fe;
    float v = 0.0f;
    switch (f) {
      case ND_FEATURE: v = __int_as_float(fm[0]); break;
      case ND_FEATURE_ENUM: v = __int_as_float(fe); break;
      case ND_THRESHOLD: v = pc[LM_BTHR * SL]; break;
      case ND_DL: v = (float)(pc[LM_BDL * SL] > 0.5f); break;
      case ND_GAIN: v = pc[LM_BGAIN * SL]; break;
      case ND_LEFT: v = __int_as_float(-(slot + 1)); break;
      case ND_RIGHT: v = __int_as_float(-(j + 2)); break;
      case ND_IVALUE: v = pc[LM_VALUE * SL]; break;
      case ND_IWEIGHT: v = pc[LM_SUM_H * SL]; break;
      case ND_ICOUNT: v = pc[LM_CNT_G * SL]; break;
      case ND_COL: v = __int_as_float(fm[1 * F]); break;
      case ND_BIN_START: v = __int_as_float(fm[2 * F]); break;
      case ND_IS_BUNDLED: v = __int_as_float(fm[3 * F]); break;
      case ND_NUM_BIN: v = __int_as_float(fm[4 * F]); break;
      case ND_DEFAULT_BIN: v = __int_as_float(fm[5 * F]); break;
      case ND_MISSING: v = __int_as_float(fm[6 * F]); break;
      default: break;
    }
    a.nmw[f * S1 + j] = v;
  }
  // the info rows of the 2K children: columns 0..4 of the selected lanes
  for (int t = tid; t < 2 * kstep * F * 5; t += FR_THREADS) {
    const int col = t % 5, r = t / 5;
    const int f = r % F, c2 = r / F;          // c2 < 2 kstep
    const int k = c2 >> 1, right = c2 & 1;
    const float* pc = a.lmw + it.sel_slot[k];
    float v = a.fmask[f];
    if (col == 0) v = pc[(right ? LM_BRSG : LM_BLSG) * SL];
    if (col == 1) v = pc[(right ? LM_BRSH : LM_BLSH) * SL];
    if (col == 2)
      v = (float)__float_as_int(pc[(right ? LM_BRCNT : LM_BLCNT) * SL]);
    if (col == 3) v = (float)(__float_as_int(pc[LM_DEPTH * SL]) + 1);
    a.info[((right ? K + k : k) * F + f) * 8 + col] = v;
  }
  // the step records
  for (int k = tid; k < kstep; k += FR_THREADS) {
    const int j = made + k;
    const int slot = it.sel_slot[k];
    const float* pc = a.lmw + slot;
    const int fe = __float_as_int(pc[LM_BFEAT * SL]);
    const int* fm = a.fmeta + fe;
    const int lcg = __float_as_int(pc[LM_BLCNT * SL]);
    const int rcg = __float_as_int(pc[LM_BRCNT * SL]);
    const int sil = lcg <= rcg;
    int* r = a.steps + k * STEP_WORDS;
    r[SB_START] = __float_as_int(pc[LM_START * SL]);
    r[SB_CNT] = __float_as_int(pc[LM_CNT * SL]);
    r[SB_COL] = fm[1 * F];
    r[SB_BSTART] = fm[2 * F];
    r[SB_ISB] = fm[3 * F];
    r[SB_NB] = fm[4 * F];
    r[SB_DBIN] = fm[5 * F];
    r[SB_MTYPE] = fm[6 * F];
    r[SB_THR] = __float_as_int(pc[LM_BTHR * SL]);
    r[SB_DL] = pc[LM_BDL * SL] > 0.5f;
    r[SB_PARENT] = slot;
    r[SB_WA] = slot;
    r[SB_WB] = j + 1;
    r[SB_SIL] = sil;
    r[SB_SIDE] = sil ? 1 : 2;
    r[SB_VALID] = 1;
    r[SB_S] = j + 1;
    r[SB_LEAF] = slot;
    r[SB_NEW] = j + 1;
  }
  if (tid == 0) {
    fs[FS_KSTEP] = kstep;
    fs[FS_PEND] = PEND_SPLIT;
    fs[FS_RUN] = 1;
    fs[FS_STEPS] += 1;
    set_handles(a, 1u);
  }
}

extern "C" int frontier_step_launch(
    int* fs, float* lmw, float* nmw, float* snap, float* lm, float* nm,
    int* steps, const int* nl, const float* pair, float* info,
    const float* sums, const int* fmeta, const int* bag, const float* fmask,
    int L, int K, int F, int row0, int N, int mode, unsigned long long handle,
    unsigned long long handle2, void* stream) {
  if (L < 2 || K < 1 || K > L - 1 || F < 1 || mode < MODE_ROOT ||
      mode > MODE_FINAL || fs == nullptr || bag == nullptr ||
      fmask == nullptr)
    return (int)cudaErrorInvalidValue;
  const FrArgs a{fs,   lmw,  nmw,  snap,  lm,  nm,    steps, nl,
                 pair, info, sums, fmeta, bag, fmask, L,     K,
                 F,    row0, N,    mode,  (cudaGraphConditionalHandle)handle,
                 (cudaGraphConditionalHandle)handle2};
  const int NI = 2 * ((L - 1) + (K - 1)) + 2;
  const size_t smem = sizeof(int) * (5 * NI + 2 * K) + NI;
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        frontier_step, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  frontier_step<<<1, FR_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- the rows' tree-start positions --------------------------------------
#define KEY_ROW 7       // ops/frontier.py KEY_ROW

__global__ void frontier_key(int* key, int N, int clear) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) key[i] = clear ? 0 : i;
}

extern "C" int frontier_key_launch(float* ghi, long long Np, int row0, int N,
                                   int clear, void* stream) {
  if (N < 0 || row0 < 0 || row0 + (long long)N > Np)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  int* key = (int*)ghi + KEY_ROW * Np + row0;
  frontier_key<<<(N + 255) / 256, 256, 0, (cudaStream_t)stream>>>(key, N,
                                                                 clear);
  return (int)cudaGetLastError();
}

// ---- the undo of the pruned ranges ----------------------------------------
struct UndoArgs {
  uint8_t* bins;          // (R, Np)
  int R;
  long long Np;
  uint32_t* ghi;          // (8, Np) words; row KEY_ROW the positions
  const int* fs;          // the frontier state
  int undo, K;            // offset of the undo list, its K entries
  uint8_t* sbins;         // (R, scap) scratch
  uint32_t* sghi;         // (8, scap) scratch
  long long scap;
};

__device__ __forceinline__ int key_at(const UndoArgs& a, long long p) {
  return (int)a.ghi[KEY_ROW * a.Np + p];
}

// Rows in [lo, hi) (ascending keys) whose key is below k.
__device__ __forceinline__ int rank_below(const UndoArgs& a, long long lo,
                                          long long hi, int k) {
  long long b = lo, e = hi;
  while (b < e) {
    const long long mid = (b + e) >> 1;
    if (key_at(a, mid) < k) b = mid + 1;
    else e = mid;
  }
  return (int)(b - lo);
}

// The range holding flat index g of the listed ranges laid end to end:
// its (start, cnt, nl) and its offset in the scratch.
__device__ __forceinline__ bool find_range(const UndoArgs& a, long long g,
                                           int n, int* s, int* c, int* l,
                                           long long* base) {
  long long off = 0;
  for (int r = 0; r < n; ++r) {
    const int* u = a.fs + a.undo + 3 * r;
    if (g < off + u[1]) {
      *s = u[0];
      *c = u[1];
      *l = u[2];
      *base = off;
      return true;
    }
    off += u[1];
  }
  return false;
}

__global__ void undo_merge(UndoArgs a) {
  const int n = a.fs[FS_NPRUNED];
  long long total = 0;
  for (int r = 0; r < n; ++r) total += a.fs[a.undo + 3 * r + 1];
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       g < total; g += (long long)gridDim.x * blockDim.x) {
    int s, c, l;
    long long base;
    if (!find_range(a, g, n, &s, &c, &l, &base)) continue;
    const int i = (int)(g - base);
    const long long p = (long long)s + i;
    const int k = key_at(a, p);
    const int d = i < l ? i + rank_below(a, s + l, s + c, k)
                        : (i - l) + rank_below(a, s, s + l, k);
    const long long q = base + d;
    for (int r = 0; r < a.R; ++r) a.sbins[r * a.scap + q] = a.bins[r * a.Np + p];
    for (int r = 0; r < 8; ++r) a.sghi[r * a.scap + q] = a.ghi[r * a.Np + p];
  }
}

__global__ void undo_copy(UndoArgs a) {
  const int n = a.fs[FS_NPRUNED];
  long long total = 0;
  for (int r = 0; r < n; ++r) total += a.fs[a.undo + 3 * r + 1];
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       g < total; g += (long long)gridDim.x * blockDim.x) {
    int s, c, l;
    long long base;
    if (!find_range(a, g, n, &s, &c, &l, &base)) continue;
    const long long p = (long long)s + (g - base), q = g;
    for (int r = 0; r < a.R; ++r) a.bins[r * a.Np + p] = a.sbins[r * a.scap + q];
    for (int r = 0; r < 8; ++r) a.ghi[r * a.Np + p] = a.sghi[r * a.scap + q];
  }
}

extern "C" int frontier_undo_launch(uint8_t* bins, int R, long long Np,
                                    uint32_t* ghi, const int* fs, int undo,
                                    int K, int bound, uint8_t* sbins,
                                    uint32_t* sghi, long long scap,
                                    void* stream) {
  if (R < 1 || K < 1 || bound < 0 || scap < bound || fs == nullptr)
    return (int)cudaErrorInvalidValue;
  int dev = 0, nsm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const UndoArgs a{bins, R, Np, ghi, fs, undo, K, sbins, sghi, scap};
  const long long want = ((long long)bound + 255) / 256;
  const int blocks = (int)(want < 8LL * nsm ? (want > 0 ? want : 1)
                                            : 8LL * nsm);
  cudaStream_t s = (cudaStream_t)stream;
  undo_merge<<<blocks, 256, 0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  undo_copy<<<blocks, 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// ---- conditional graph nodes ----------------------------------------------
// A handle on the graph being captured on `stream`, reset to 0 at every
// launch of the graph.
extern "C" int cond_handle_create(void* stream,
                                  unsigned long long* handle_out) {
  cudaStreamCaptureStatus st;
  cudaGraph_t g;
  const cudaGraphNode_t* deps;
  size_t nd;
  cudaError_t e = cudaStreamGetCaptureInfo((cudaStream_t)stream, &st, nullptr,
                                           &g, &deps, &nd);
  if (e != cudaSuccess) return (int)e;
  if (st != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle h;
  e = cudaGraphConditionalHandleCreate(&h, g, 0, cudaGraphCondAssignDefault);
  *handle_out = (unsigned long long)h;
  return (int)e;
}

// Add an IF node on `handle` after the work captured so far on `stream`,
// make it the stream's only dependency, and capture `body` into the IF
// node's body graph until cond_if_end.
extern "C" int cond_if_begin(void* stream, void* body,
                             unsigned long long handle) {
  cudaStreamCaptureStatus st;
  cudaGraph_t g;
  const cudaGraphNode_t* deps;
  size_t nd;
  cudaError_t e = cudaStreamGetCaptureInfo((cudaStream_t)stream, &st, nullptr,
                                           &g, &deps, &nd);
  if (e != cudaSuccess) return (int)e;
  if (st != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = (cudaGraphConditionalHandle)handle;
  p.conditional.type = cudaGraphCondTypeIf;
  p.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, g, deps, nd, &p);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies((cudaStream_t)stream, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)body, p.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeRelaxed);
}

extern "C" int cond_if_end(void* body) {
  cudaGraph_t g;
  return (int)cudaStreamEndCapture((cudaStream_t)body, &g);
}
