// The step block: one small int32 array on the device that says which
// leaf a split step works on.  The partition, the split mega-kernel and
// the leaf histogram read their range, decision and histogram-state
// slots from it instead of taking them as host ints, so that a captured
// CUDA graph replays a whole tree with the bookkeeping kernel
// (csrc/tree_step.cu) writing the next step's block on the device.  The
// layout is ops/partition.py's SB_*.
//
// A step with cnt == 0 (the tree has stopped, or a host call of no rows)
// writes no row, no histogram-state slot and no tree column.  A kernel
// that finds the block outside the bounds its launch was sized for sets
// a bit of SB_ERR and treats the step as cnt == 0; the learner reads the
// word once a tree and raises.
#pragma once

#define SB_START 0      // first row of the leaf range
#define SB_CNT 1        // rows in the range (0: write nothing)
#define SB_COL 2        // group row of the split feature
#define SB_BSTART 3     // bundled bin offset
#define SB_ISB 4        // feature is bundled (0/1)
#define SB_NB 5         // feature num_bin
#define SB_DBIN 6       // feature default bin
#define SB_MTYPE 7      // missing type (0 none / 1 zero / 2 nan)
#define SB_THR 8        // split threshold (bin)
#define SB_DL 9         // default_left (0/1)
#define SB_PARENT 10    // histogram-state slot of the parent (-1: none)
#define SB_WA 11        // slot the left child is written to
#define SB_WB 12        // slot the right child is written to
#define SB_SIL 13       // the smaller child is the left one (0/1)
#define SB_SIDE 14      // rows histogrammed: 0 range, 1 left, 2 right child
#define SB_VALID 15     // the step splits a leaf (tree_step's election)
#define SB_S 16         // splits elected so far in this tree
#define SB_LEAF 17      // leaf being split (keeps the left child)
#define SB_NEW 18       // leaf the right child takes
#define SB_PEND 19      // commit due: 0 none, 1 the root, 2 a split
#define SB_DONE 20      // the tree has stopped
#define SB_ERR 21       // error bits (ERR_*), 0 while all is well
#define SB_MADE 22      // frontier: splits made, pruned ones included
#define SB_STEPS 23     // frontier: steps run
#define SB_ISCAT 24     // categorical split: left iff the bin is in the set
#define SB_CAT 25       // the set, W words (bit b & 31 of word b >> 5)
// W: 8 words (256 bins, every uint8 dataset), or ceil(B / 32) on uint16
// data; a step block is SB_CAT + W words, STEP_WORDS at the least (the
// frontier's step records, uint8 only, are STEP_WORDS apart)
#define CAT_WORDS 8
#define STEP_WORDS 33

#define ERR_RANGE 1     // range or column outside the launch's bounds
#define ERR_STATE 2     // histogram-state slot outside the state
#define ERR_STEP 4      // tree_step met a leaf or feature out of range

__device__ __forceinline__ void step_error(int* step, int bit) {
  atomicOr(step + SB_ERR, bit);
}
