// The packed tree matrices of the port's tree loop (models/learner.py,
// ops/tree_step.py): leafmat rows LM_*, nodemat rows ND_*, the feature
// metadata's rows.  Shared by csrc/tree_step.cu and csrc/frontier.cu.
#pragma once

#include <math.h>

// leafmat rows (models/learner.py LM_*)
#define LM_START 0
#define LM_CNT 1
#define LM_CNT_G 2
#define LM_SUM_G 3
#define LM_SUM_H 4
#define LM_DEPTH 5
#define LM_CMIN 6
#define LM_CMAX 7
#define LM_VALUE 8
#define LM_PARENT 9
#define LM_PSIDE 10
#define LM_BGAIN 11
#define LM_BFEAT 12
#define LM_BTHR 13
#define LM_BDL 14
#define LM_BLCNT 15
#define LM_BRCNT 16
#define LM_BLSG 17
#define LM_BLSH 18
#define LM_BRSG 19
#define LM_BRSH 20
#define LM_BLOUT 21
#define LM_BROUT 22
#define LM_BISCAT 23
#define LM_FORCED 24
#define NLF 25
#define SEG 13          // LM_BGAIN .. LM_BISCAT, the pair search's row

// nodemat rows (models/learner.py ND_*)
#define ND_FEATURE 0
#define ND_FEATURE_ENUM 1
#define ND_THRESHOLD 2
#define ND_DL 3
#define ND_GAIN 4
#define ND_LEFT 5
#define ND_RIGHT 6
#define ND_IVALUE 7
#define ND_IWEIGHT 8
#define ND_ICOUNT 9
#define ND_COL 10
#define ND_BIN_START 11
#define ND_IS_BUNDLED 12
#define ND_NUM_BIN 13
#define ND_DEFAULT_BIN 14
#define ND_MISSING 15
#define ND_IS_CAT 16
#define NND 17

// fmeta rows: feature id, group row, bin_start, is_bundled, num_bin,
// default_bin, missing_type, monotone direction; one column per feature
#define FMETA_ROWS 8
#define SEG 13          // LM_BGAIN .. LM_BISCAT, the pair search's row

// One leafmat column (models/learner.py _leaf_column) at col, its rows
// `stride` floats apart: the leaf's fields, then the 13 fields of its
// best split as the search wrote them.
__device__ __forceinline__ void write_leaf_column(
    float* col, int stride, int start, int cnt, int cnt_g, float sg,
    float sh, int depth, float value, int parent, int side,
    const float* seg) {
  col[LM_START * stride] = __int_as_float(start);
  col[LM_CNT * stride] = __int_as_float(cnt);
  col[LM_CNT_G * stride] = __int_as_float(cnt_g);
  col[LM_SUM_G * stride] = sg;
  col[LM_SUM_H * stride] = sh;
  col[LM_DEPTH * stride] = __int_as_float(depth);
  col[LM_CMIN * stride] = -INFINITY;
  col[LM_CMAX * stride] = INFINITY;
  col[LM_VALUE * stride] = value;
  col[LM_PARENT * stride] = __int_as_float(parent);
  col[LM_PSIDE * stride] = __int_as_float(side);
  for (int i = 0; i < SEG; ++i) col[(LM_BGAIN + i) * stride] = seg[i];
  col[LM_FORCED * stride] = __int_as_float(-1);
}

// The value of field f of an empty leafmat column (ops/tree_step.py
// empty_leafmat).
__device__ __forceinline__ float empty_leaf_field(int f) {
  if (f == LM_BGAIN || f == LM_CMIN) return -INFINITY;
  if (f == LM_CMAX) return INFINITY;
  if (f == LM_PARENT || f == LM_FORCED) return __int_as_float(-1);
  return 0.0f;
}

// The argmax order: a NaN beats any number, the larger number wins, and
// on a tie the smaller index.
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  const bool vn = isnan(v), wn = isnan(w);
  if (vn != wn) return vn;
  if (!vn && v != w) return v > w;
  return i < j;
}
