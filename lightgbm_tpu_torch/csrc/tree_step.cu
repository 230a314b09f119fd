// The tree loop's bookkeeping step on Hopper: what the learner's host loop
// did between two splits, done on the device so that a captured CUDA
// graph grows a whole tree with no host round trip.
//
// It has no TPU kernel to replace: in the JAX package these are XLA
// operations inside the while-loop body of _build_tree_impl
// (lightgbm_tpu/models/learner.py).  Its plain PyTorch version is
// tree_step_plain in lightgbm_tpu_torch/ops/tree_step.py, and the two
// agree bit for bit: the work is integer bookkeeping, comparisons and f32
// copies, with the only conversions int -> f32 of counts below 2^24.
//
// Matrices (models/learner.py): leafmat (NLF, L + 1) and nodemat (NND,
// nodes + 1) f32, row-major, int fields bitcast into f32; column L of
// leafmat and column `nodes` of nodemat are spare.  The step block is
// csrc/step.cuh's.  One launch of one block:
//   mode 0 (root): reset both matrices as an empty tree, write the root
//     search's (2F, 8) info block from the root histogram's sums, the
//     bag-aware count (a device word: the sampling pass writes it, so a
//     captured graph serves every draw) and the (F,) feature mask, and
//     mark the root's column as due;
//   mode 1 (step): commit what is due, then elect the next split;
//   mode 2 (final): commit what is due.
// Commit: the root's column from the root search's row and sums; or the
// two children of the split just made, from the partition's left count
// and the pair search's (2, 13) rows, into the parent's column and column
// `new`, as models/learner.py _leaf_column writes them.  Elect: the first
// index of the largest LM_BGAIN over the L leaves (a NaN counts as the
// largest, as numpy's and jax's argmax take it); the split is made when
// s < nodes, the gain is > 0 (a NaN gain is not) and the tree has not
// stopped.  Then it writes the internal node's column s and the parent's
// child pointer, the children's info block (feature mask from the mask
// vector), and the step block of the split for the kernels: range,
// decision, histogram-state slots (parent,
// wa = the leaf, wb = the new leaf, small_is_left = left count <= right
// count by the bag-aware counts, ties left) and the side histogrammed.
// A split not made sets cnt = 0 and stops the tree: every later step
// writes no column, no slot and no row.
//
// The category sets ride beside the matrices as bitsets of bins:
// leafcat (L + 1, W), nodecat (nodes + 1, W) and paircat (2, W) int32,
// W words a set (8 up to 256 bins, ceil(B / 32) on uint16 data; one
// width a learner, fixed at the graph's capture), and the step block is
// SB_CAT + W words.
// The root's reset zeroes leafcat and nodecat, a commit copies each
// child's set from paircat (csrc/split_cat.cu) into its leaf's row, and an
// election copies the leaf's set into the node's row, writes ND_IS_CAT
// from LM_BISCAT and puts the flag and the set into the step block
// (SB_ISCAT, SB_CAT) for the partition.  On numerical data split_pair
// writes LM_BISCAT = 0 and paircat stays zero, so all of these are 0.
//
// Monotone constraints (fmeta row 7: each feature's direction, zeros
// without them): the children's output bounds are the parent's
// [LM_CMIN, LM_CMAX], tightened to the mid of the two outputs on the side
// a monotone feature's direction says for a numerical split (the
// reference's BasicLeafConstraints, child_bounds below).  The election
// writes them into the children's info rows (columns 5, 6), the commit
// into their leafmat columns; the root's are -inf and +inf.  With the
// boxes (intermediate constraints: (2, L + 1, F) int32, each leaf's lowest
// and highest bin per feature, or null) the root's reset writes row 0 and
// a commit the two children's boxes (child_boxes below).
//
// What bounds it on this card: latency.  It moves two leafmat columns, a
// nodemat column, the info block and the step block (a few KB) and reads
// the L gains; one block of 256 threads does it in a few dependent steps.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "step.cuh"
#include "tree_cols.cuh"

#define STEP_THREADS 256
#define CAT_WARP 32     // the first thread of the warp that moves the sets
#define MODE_ROOT 0
#define MODE_STEP 1
#define MODE_FINAL 2

struct TreeArgs {
  float* lm;            // (NLF, L + 1)
  float* nm;            // (NND, nodes + 1)
  int* step;            // SB_CAT + W
  const int* nl;        // (1,): the partition's left count
  const float* pair;    // (2, SEG): the pair search's rows
  const int* fmeta;     // (FMETA_ROWS, F)
  float* info;          // (2F, 8): the next search's info block
  const float* sums;    // (2,): the root histogram's grad and hess sums
  const int* bag;       // (1,): the root's bag-aware row count
  const float* fmask;   // (F,): the tree's feature mask (0 / 1)
  int* leafcat;         // (L + 1, W)
  int* nodecat;         // (nodes + 1, W)
  const int* paircat;   // (2, W)
  int* boxes;           // (2, L + 1, F) or null: the leaves' bin boxes
  int L, nodes, F, row0, N, mode, W;
};

// The children's bounds (left cmin, left cmax, right cmin, right cmax) of
// the split in the leafmat column pcol on a feature of direction mono.
__device__ __forceinline__ void child_bounds(const float* pcol, int mono,
                                             float* b) {
  const float pmin = pcol[LM_CMIN], pmax = pcol[LM_CMAX];
  const float mid = (pcol[LM_BLOUT] + pcol[LM_BROUT]) * 0.5f;
  const bool num = !(pcol[LM_BISCAT] > 0.5f);
  b[0] = num && mono < 0 ? fmaxf(pmin, mid) : pmin;
  b[1] = num && mono > 0 ? fminf(pmax, mid) : pmax;
  b[2] = num && mono > 0 ? fmaxf(pmin, mid) : pmin;
  b[3] = num && mono < 0 ? fminf(pmax, mid) : pmax;
}

// The children's boxes of the split of `leaf` (column pcol) into rows
// `leaf` and `nw`, feature f by thread (JAX learner.py _child_boxes): the
// parent's box; along a numerical split's feature the left child's upper
// end min(hi, thr) unless the missing / default bin goes left from past
// the threshold, the right child's lower end max(lo, thr + 1) unless it
// goes right from at or below it.
__device__ __forceinline__ void child_boxes(const TreeArgs& a,
                                            const float* pcol, int leaf,
                                            int nw) {
  const int L1F = (a.L + 1) * a.F, F = a.F;
  const int fe = __float_as_int(pcol[LM_BFEAT]);
  const int thr = __float_as_int(pcol[LM_BTHR]);
  const bool dl = pcol[LM_BDL] > 0.5f, iscat = pcol[LM_BISCAT] > 0.5f;
  const int nb = a.fmeta[4 * F + fe], dbin = a.fmeta[5 * F + fe];
  const int mtype = a.fmeta[6 * F + fe];
  const int d_eff = mtype == 2 ? nb - 1 : dbin;
  const bool miss_l = mtype != 0 && dl && d_eff > thr;
  const bool miss_r = mtype != 0 && !dl && d_eff <= thr;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const int lo = a.boxes[leaf * F + f], hi = a.boxes[L1F + leaf * F + f];
    const bool cut = f == fe && !iscat;
    a.boxes[L1F + leaf * F + f] = cut && !miss_l ? min(hi, thr) : hi;
    a.boxes[nw * F + f] = cut && !miss_r ? max(lo, thr + 1) : lo;
    a.boxes[L1F + nw * F + f] = hi;
  }
}

__device__ __forceinline__ void leaf_column(
    const TreeArgs& a, int leaf, int start, int cnt, int cnt_g, float sg,
    float sh, int depth, float value, int parent, int side,
    const float* seg) {
  write_leaf_column(a.lm + leaf, a.L + 1, start, cnt, cnt_g, sg, sh, depth,
                    value, parent, side, seg);
}

// WC: the sets' words when known at compile time (CAT_WORDS, every
// uint8 dataset: the loops over the words fold into single guarded
// moves), 0 for a.W words (uint16 data).
template <int WC>
__global__ void __launch_bounds__(STEP_THREADS) tree_step(TreeArgs a) {
  __shared__ float pcol[NLF];
  __shared__ float s_val[STEP_THREADS];
  __shared__ int s_idx[STEP_THREADS];
  extern __shared__ int s_cat[];     // W words (dynamic)
  __shared__ int s_pend, s_valid, s_leaf, s_new, s_s, s_fe, s_depth;
  const int tid = threadIdx.x;
  const int L1 = a.L + 1, N1 = a.nodes + 1, F = a.F;
  const int W = WC ? WC : a.W;
  int* step = a.step;

  if (a.mode == MODE_ROOT) {
    for (int i = tid; i < NLF * L1; i += STEP_THREADS) {
      a.lm[i] = empty_leaf_field(i / L1);
    }
    for (int i = tid; i < NND * N1; i += STEP_THREADS) a.nm[i] = 0.0f;
    const float in[8] = {a.sums[0], a.sums[1], (float)*a.bag, 0.0f, 0.0f,
                         -INFINITY, INFINITY, 0.0f};
    for (int i = tid; i < 2 * F * 8; i += STEP_THREADS)
      a.info[i] = (i & 7) == 4 ? a.fmask[(i >> 3) % F] : in[i & 7];
    for (int i = tid; i < SB_CAT + W; i += STEP_THREADS)
      step[i] = i == SB_PEND ? 1 : 0;
    for (int i = tid; i < L1 * W; i += STEP_THREADS) a.leafcat[i] = 0;
    for (int i = tid; i < N1 * W; i += STEP_THREADS) a.nodecat[i] = 0;
    if (a.boxes)
      for (int f = tid; f < F; f += STEP_THREADS) {
        a.boxes[f] = 0;
        a.boxes[L1 * F + f] = a.fmeta[4 * F + f] - 1;
      }
    return;
  }

  // ---- commit -----------------------------------------------------
  if (tid == 0) {
    s_pend = step[SB_PEND];
    s_leaf = step[SB_LEAF];
    s_new = step[SB_NEW];
    s_s = step[SB_S];
  }
  __syncthreads();
  const int pend = s_pend;
  if (pend == 2 && tid < NLF) pcol[tid] = a.lm[tid * L1 + s_leaf];
  __syncthreads();
  if (pend == 1 && tid == 0) {
    leaf_column(a, 0, a.row0, a.N, *a.bag, a.sums[0], a.sums[1], 0, 0.0f,
                -1, 0, a.pair);
  } else if (pend == 2 && tid < 2) {
    const int start = __float_as_int(pcol[LM_START]);
    const int cnt = __float_as_int(pcol[LM_CNT]);
    const int depth = __float_as_int(pcol[LM_DEPTH]) + 1;
    const int nl = *a.nl;
    const int node = s_s - 1;
    float b[4];
    child_bounds(pcol, a.fmeta[7 * F + __float_as_int(pcol[LM_BFEAT])], b);
    const int leaf = tid == 0 ? s_leaf : s_new;
    if (tid == 0)
      leaf_column(a, s_leaf, start, nl, __float_as_int(pcol[LM_BLCNT]),
                  pcol[LM_BLSG], pcol[LM_BLSH], depth, pcol[LM_BLOUT], node,
                  0, a.pair);
    else
      leaf_column(a, s_new, start + nl, cnt - nl,
                  __float_as_int(pcol[LM_BRCNT]), pcol[LM_BRSG],
                  pcol[LM_BRSH], depth, pcol[LM_BROUT], node, 1,
                  a.pair + SEG);
    a.lm[LM_CMIN * L1 + leaf] = b[2 * tid];
    a.lm[LM_CMAX * L1 + leaf] = b[2 * tid + 1];
  }
  // the children's boxes by the other threads (their reads of the
  // parent's row come before their writes, feature by feature)
  if (pend == 2 && a.boxes) child_boxes(a, pcol, s_leaf, s_new);
  // the sets by the second warp, beside the first's leaf columns
  if (tid >= CAT_WARP && tid < CAT_WARP + 32) {
    for (int i = tid - CAT_WARP; i < 2 * W; i += 32) {
      const int c = i >= W, j = i - c * W;
      if (pend == 1 && c == 0)
        a.leafcat[j] = a.paircat[j];
      else if (pend == 2)
        a.leafcat[(c ? s_new : s_leaf) * W + j] = a.paircat[i];
    }
  }
  __syncthreads();
  if (a.mode == MODE_FINAL) {
    if (tid == 0) step[SB_PEND] = 0;
    return;
  }

  // ---- elect ------------------------------------------------------
  float bv = NAN;
  int bi = -1;
  for (int j = tid; j < a.L; j += STEP_THREADS) {
    const float v = a.lm[LM_BGAIN * L1 + j];
    if (bi < 0 || before(v, j, bv, bi)) {
      bv = v;
      bi = j;
    }
  }
  s_val[tid] = bv;
  s_idx[tid] = bi;
  __syncthreads();
  for (int o = STEP_THREADS / 2; o > 0; o >>= 1) {
    if (tid < o) {
      const int j = s_idx[tid + o];
      if (j >= 0 && (s_idx[tid] < 0 ||
                     before(s_val[tid + o], j, s_val[tid], s_idx[tid]))) {
        s_val[tid] = s_val[tid + o];
        s_idx[tid] = j;
      }
    }
    __syncthreads();
  }
  // the leaf's set is read by the second warp while thread 0 reads its
  // column (the commit's writes are visible after the barriers above)
  if (tid >= CAT_WARP && tid < CAT_WARP + 32)
    for (int j = tid - CAT_WARP; j < W; j += 32)
      s_cat[j] = a.leafcat[s_idx[0] * W + j];
  if (tid == 0) {
    const int best = s_idx[0];
    const float gain = s_val[0];
    const int s = s_s;
    bool valid = s < a.nodes && gain > 0.0f && !step[SB_DONE] && F > 0;
    if (valid) {
      for (int f = 0; f < NLF; ++f) pcol[f] = a.lm[f * L1 + best];
      const int fe = __float_as_int(pcol[LM_BFEAT]);
      const int p = __float_as_int(pcol[LM_PARENT]);
      if (fe < 0 || fe >= F || p >= a.nodes) {
        step_error(step, ERR_STEP);
        valid = false;
      }
      s_fe = fe;
    }
    s_valid = valid;
    s_leaf = best;
    s_new = s + 1;
    s_depth = valid ? __float_as_int(pcol[LM_DEPTH]) + 1 : 0;
    if (!valid) {
      step[SB_CNT] = 0;
      step[SB_VALID] = 0;
      step[SB_DONE] = 1;
      step[SB_PEND] = 0;
    }
  }
  __syncthreads();
  if (!s_valid) return;
  const int best = s_leaf, nw = s_new, s = s_s, fe = s_fe;
  const int* fm = a.fmeta + fe;
  const int lcg = __float_as_int(pcol[LM_BLCNT]);
  const int rcg = __float_as_int(pcol[LM_BRCNT]);
  const int thr = __float_as_int(pcol[LM_BTHR]);
  const int dl = pcol[LM_BDL] > 0.5f;
  if (tid < NND) {
    float v = 0.0f;
    switch (tid) {
      case ND_FEATURE: v = __int_as_float(fm[0]); break;
      case ND_FEATURE_ENUM: v = __int_as_float(fe); break;
      case ND_THRESHOLD: v = __int_as_float(thr); break;
      case ND_DL: v = (float)dl; break;
      case ND_GAIN: v = pcol[LM_BGAIN]; break;
      case ND_LEFT: v = __int_as_float(-(best + 1)); break;
      case ND_RIGHT: v = __int_as_float(-(nw + 1)); break;
      case ND_IVALUE: v = pcol[LM_VALUE]; break;
      case ND_IWEIGHT: v = pcol[LM_SUM_H]; break;
      case ND_ICOUNT: v = pcol[LM_CNT_G]; break;
      case ND_COL: v = __int_as_float(fm[1 * F]); break;
      case ND_BIN_START: v = __int_as_float(fm[2 * F]); break;
      case ND_IS_BUNDLED: v = __int_as_float(fm[3 * F]); break;
      case ND_NUM_BIN: v = __int_as_float(fm[4 * F]); break;
      case ND_DEFAULT_BIN: v = __int_as_float(fm[5 * F]); break;
      case ND_MISSING: v = __int_as_float(fm[6 * F]); break;
      case ND_IS_CAT: v = (float)(pcol[LM_BISCAT] > 0.5f); break;
      default: break;
    }
    a.nm[tid * N1 + s] = v;
  }
  for (int j = tid; j < W; j += STEP_THREADS) {
    const int word = s_cat[j];
    a.nodecat[s * W + j] = word;
    step[SB_CAT + j] = word;
  }
  if (tid == 0) step[SB_ISCAT] = pcol[LM_BISCAT] > 0.5f;
  float b[4];
  child_bounds(pcol, fm[7 * F], b);
  for (int i = tid; i < 2 * F * 8; i += STEP_THREADS) {
    const int c = i / (F * 8), k = i & 7;
    float v = 0.0f;
    if (k == 0) v = pcol[c ? LM_BRSG : LM_BLSG];
    if (k == 1) v = pcol[c ? LM_BRSH : LM_BLSH];
    if (k == 2) v = (float)(c ? rcg : lcg);
    if (k == 3) v = (float)s_depth;
    if (k == 4) v = a.fmask[(i >> 3) % F];
    if (k == 5) v = b[2 * c];
    if (k == 6) v = b[2 * c + 1];
    a.info[i] = v;
  }
  if (tid == 0) {
    const int p = __float_as_int(pcol[LM_PARENT]);
    if (p >= 0)
      a.nm[(__float_as_int(pcol[LM_PSIDE]) == 0 ? ND_LEFT : ND_RIGHT) * N1 +
           p] = __int_as_float(s);
    const int sil = lcg <= rcg;
    step[SB_START] = __float_as_int(pcol[LM_START]);
    step[SB_CNT] = __float_as_int(pcol[LM_CNT]);
    step[SB_COL] = fm[1 * F];
    step[SB_BSTART] = fm[2 * F];
    step[SB_ISB] = fm[3 * F];
    step[SB_NB] = fm[4 * F];
    step[SB_DBIN] = fm[5 * F];
    step[SB_MTYPE] = fm[6 * F];
    step[SB_THR] = thr;
    step[SB_DL] = dl;
    step[SB_PARENT] = best;
    step[SB_WA] = best;
    step[SB_WB] = nw;
    step[SB_SIL] = sil;
    step[SB_SIDE] = sil ? 1 : 2;
    step[SB_VALID] = 1;
    step[SB_S] = s + 1;
    step[SB_LEAF] = best;
    step[SB_NEW] = nw;
    step[SB_PEND] = 2;
  }
}

extern "C" int tree_step_launch(float* lm, float* nm, int* step,
                                const int* nl, const float* pair,
                                const int* fmeta, float* info,
                                const float* sums, const int* bag,
                                const float* fmask, int* leafcat,
                                int* nodecat, const int* paircat, int* boxes,
                                int L, int nodes, int F, int row0, int N,
                                int mode, int W, void* stream) {
  if (L < 2 || nodes != L - 1 || F < 0 || W < CAT_WORDS ||
      W * sizeof(int) > 48 * 1024 || mode < MODE_ROOT || mode > MODE_FINAL ||
      lm == nullptr || nm == nullptr || step == nullptr || bag == nullptr ||
      leafcat == nullptr || nodecat == nullptr || paircat == nullptr)
    return (int)cudaErrorInvalidValue;
  const TreeArgs a{lm,      nm,      step,    nl,    pair,  fmeta,
                   info,    sums,    bag,     fmask, leafcat,
                   nodecat, paircat, boxes,   L,     nodes, F,
                   row0,    N,       mode,    W};
  if (W == CAT_WORDS)
    tree_step<CAT_WORDS>
        <<<1, STEP_THREADS, W * sizeof(int), (cudaStream_t)stream>>>(a);
  else
    tree_step<0><<<1, STEP_THREADS, W * sizeof(int), (cudaStream_t)stream>>>(
        a);
  return (int)cudaGetLastError();
}
