"""Parameter system of the PyTorch/CUDA port.

A copy of the JAX package's parameter table (lightgbm_tpu/config.py), so
one params dict trains in both packages, with two differences:
``device_type`` defaults to ``cuda`` (``cpu`` runs the kernels' plain
PyTorch versions), and ``Config.check_supported`` raises
NotImplementedError naming any param that asks for a path this port
does not have yet.

Port of the reference parameter schema
(include/LightGBM/config.h, src/io/config.cpp, src/io/config_auto.cpp):
the same parameter names, aliases, defaults and validation rules, but held in a
single table-driven Python ``Config`` instead of a generated C++ struct.

The alias table and defaults follow `config_auto.cpp` (GetMembersFromString
/ parameter2aliases); the derived-flag logic follows `Config::Set`
(src/io/config.cpp).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from .utils import log

_NO_DEFAULT = object()


@dataclass
class _Param:
    name: str
    default: Any
    typ: type
    aliases: Tuple[str, ...] = ()
    check: Optional[str] = None  # e.g. ">=0.0", ">0", "0.0<=x<=1.0"


def _p(name, default, typ, aliases=(), check=None):
    return _Param(name, default, typ, tuple(aliases), check)


# ---------------------------------------------------------------------------
# Parameter table — mirrors config.h sections: Core / Learning control / IO /
# Objective / Metric / Network / Device.  (reference: include/LightGBM/config.h)
# ---------------------------------------------------------------------------
_PARAMS: List[_Param] = [
    # --- Core ---
    _p("config", "", str, ("config_file",)),
    _p("task", "train", str, ("task_type",)),
    _p("objective", "regression", str,
       ("objective_type", "app", "application", "loss")),
    _p("boosting", "gbdt", str, ("boosting_type", "boost")),
    _p("data_sample_strategy", "bagging", str),
    _p("data", "", str, ("train", "train_data", "train_data_file", "data_filename")),
    _p("valid", "", str, ("test", "valid_data", "valid_data_file", "test_data",
                          "test_data_file", "valid_filenames")),
    _p("num_iterations", 100, int,
       ("num_iteration", "n_iter", "num_tree", "num_trees", "num_round",
        "num_rounds", "nrounds", "num_boost_round", "n_estimators", "max_iter"),
       ">=0"),
    _p("learning_rate", 0.1, float, ("shrinkage_rate", "eta"), ">0.0"),
    _p("num_leaves", 31, int,
       ("num_leaf", "max_leaves", "max_leaf", "max_leaf_nodes"), ">1"),
    _p("tree_learner", "serial", str,
       ("tree", "tree_type", "tree_learner_type")),
    _p("num_threads", 0, int,
       ("num_thread", "nthread", "nthreads", "n_jobs")),
    _p("device_type", "cuda", str, ("device",)),
    _p("seed", None, int, ("random_seed", "random_state")),
    _p("deterministic", False, bool),
    # --- Learning control ---
    _p("force_col_wise", False, bool),
    _p("force_row_wise", False, bool),
    _p("histogram_pool_size", -1.0, float, ("hist_pool_size",)),
    _p("max_depth", -1, int),
    _p("min_data_in_leaf", 20, int,
       ("min_data_per_leaf", "min_data", "min_child_samples", "min_samples_leaf"),
       ">=0"),
    _p("min_sum_hessian_in_leaf", 1e-3, float,
       ("min_sum_hessian_per_leaf", "min_sum_hessian", "min_hessian",
        "min_child_weight"), ">=0.0"),
    _p("bagging_fraction", 1.0, float,
       ("sub_row", "subsample", "bagging"), "0.0<x<=1.0"),
    _p("pos_bagging_fraction", 1.0, float,
       ("pos_sub_row", "pos_subsample", "pos_bagging"), "0.0<x<=1.0"),
    _p("neg_bagging_fraction", 1.0, float,
       ("neg_sub_row", "neg_subsample", "neg_bagging"), "0.0<x<=1.0"),
    _p("bagging_freq", 0, int, ("subsample_freq",)),
    _p("bagging_seed", 3, int, ("bagging_fraction_seed",)),
    _p("bagging_by_query", False, bool),
    _p("feature_fraction", 1.0, float,
       ("sub_feature", "colsample_bytree"), "0.0<x<=1.0"),
    _p("feature_fraction_bynode", 1.0, float,
       ("sub_feature_bynode", "colsample_bynode"), "0.0<x<=1.0"),
    _p("feature_fraction_seed", 2, int),
    _p("extra_trees", False, bool, ("extra_tree",)),
    _p("extra_seed", 6, int),
    _p("early_stopping_round", 0, int,
       ("early_stopping_rounds", "early_stopping", "n_iter_no_change")),
    _p("early_stopping_min_delta", 0.0, float, (), ">=0.0"),
    _p("first_metric_only", False, bool),
    _p("max_delta_step", 0.0, float, ("max_tree_output", "max_leaf_output")),
    _p("lambda_l1", 0.0, float, ("reg_alpha", "l1_regularization"), ">=0.0"),
    _p("lambda_l2", 0.0, float,
       ("reg_lambda", "lambda", "l2_regularization"), ">=0.0"),
    _p("linear_lambda", 0.0, float, (), ">=0.0"),
    _p("min_gain_to_split", 0.0, float, ("min_split_gain",), ">=0.0"),
    _p("drop_rate", 0.1, float, ("rate_drop",), "0.0<=x<=1.0"),
    _p("max_drop", 50, int),
    _p("skip_drop", 0.5, float, (), "0.0<=x<=1.0"),
    _p("xgboost_dart_mode", False, bool),
    _p("uniform_drop", False, bool),
    _p("drop_seed", 4, int),
    _p("top_rate", 0.2, float, (), "0.0<=x<=1.0"),
    _p("other_rate", 0.1, float, (), "0.0<=x<=1.0"),
    _p("min_data_per_group", 100, int, (), ">0"),
    _p("max_cat_threshold", 32, int, (), ">0"),
    _p("cat_l2", 10.0, float, (), ">=0.0"),
    _p("cat_smooth", 10.0, float, (), ">=0.0"),
    _p("max_cat_to_onehot", 4, int, (), ">0"),
    _p("top_k", 20, int, ("topk",), ">0"),
    _p("monotone_constraints", "", str, ("mc", "monotone_constraint")),
    _p("monotone_constraints_method", "basic", str, ("monotone_constraining_method", "mc_method")),
    _p("monotone_penalty", 0.0, float, ("monotone_splits_penalty", "ms_penalty", "mc_penalty"), ">=0.0"),
    _p("feature_contri", "", str, ("feature_contrib", "fc", "fp", "feature_penalty")),
    _p("forcedsplits_filename", "", str, ("fs", "forced_splits_filename", "forced_splits_file", "forced_splits")),
    _p("refit_decay_rate", 0.9, float, (), "0.0<=x<=1.0"),
    _p("cegb_tradeoff", 1.0, float, (), ">=0.0"),
    _p("cegb_penalty_split", 0.0, float, (), ">=0.0"),
    _p("cegb_penalty_feature_lazy", "", str),
    _p("cegb_penalty_feature_coupled", "", str),
    _p("path_smooth", 0.0, float, (), ">=0.0"),
    _p("interaction_constraints", "", str),
    _p("verbosity", 1, int, ("verbose",)),
    _p("input_model", "", str, ("model_input", "model_in")),
    _p("output_model", "LightGBM_model.txt", str,
       ("model_output", "model_out")),
    _p("saved_feature_importance_type", 0, int),
    _p("snapshot_freq", -1, int, ("save_period",)),
    # --- Robustness (new in this framework; lightgbm_tpu/robustness/) ---
    # iteration-level checkpointing: every checkpoint_interval iterations
    # the full training state (model text + scores + RNG streams + eval
    # history) is written atomically under checkpoint_dir, keeping the
    # newest checkpoint_keep snapshots; train(resume=True) (or
    # checkpoint_resume=true) continues bit-exact from the latest one
    _p("checkpoint_dir", "", str, ("checkpoint_directory",)),
    _p("checkpoint_interval", 0, int, ("checkpoint_freq",), ">=0"),
    _p("checkpoint_keep", 2, int, ("checkpoint_keep_last",), ">0"),
    _p("checkpoint_resume", False, bool, ("resume_from_checkpoint",)),
    # what to do when gradients/hessians/scores stop being finite:
    # none (no checks) | raise | skip_iteration | clamp
    _p("nonfinite_policy", "none", str, ("non_finite_policy",)),
    # distributed bootstrap hardening (parallel/network.py): retry
    # attempts around jax.distributed.initialize with exponential
    # backoff (deadline = time_out)
    _p("bootstrap_retries", 5, int, (), ">0"),
    _p("bootstrap_retry_delay", 1.0, float, (), ">0.0"),
    # --- Observability (lightgbm_tpu/obs/) ---
    # runtime telemetry: "off" (default; zero host bookkeeping and —
    # pinned by the jaxlint telemetry.off budget — zero ops in any
    # lowered program), "counters" (host-side spans/counters/compile
    # detectors + per-(kind,bucket) serving latency histograms),
    # "trace" (counters plus a bounded event log exportable as Chrome
    # trace / JSONL / Prometheus, with jax.profiler span bridging).
    # Session-wide and upgrade-only; see Booster.telemetry_report()
    _p("telemetry", "off", str, ("telemetry_mode",)),
    # directory where the CLI writes telemetry.jsonl / trace.json /
    # metrics.prom when the task finishes ("" = no export)
    _p("telemetry_out", "", str, ("telemetry_dir",)),
    # loading a model whose saved params carry telemetry=counters|trace
    # (or health=...) does NOT re-arm the process-wide session by
    # default (a one-time warning names what was skipped); set this (or
    # LIGHTGBM_TPU_OBS_REARM_ON_LOAD=1) to opt back into re-arming —
    # see README "Observability"
    _p("obs_rearm_on_load", False, bool),
    # model & data health (lightgbm_tpu/obs/health.py + digest.py),
    # riding the telemetry modes: "off" (default; zero host bookkeeping
    # and — pinned by the jaxlint health.off budget — zero ops in any
    # lowered program), "counters" (training flight recorder + reference
    # profile + serving-side skew digests, all host-side), "trace"
    # (counters plus flight-recorder / skew-alert marks on the telemetry
    # ring — upgrades the telemetry session to trace so the PR-7
    # exporters carry them).  See Booster.health_report()
    _p("health", "off", str, ("health_mode",)),
    # top-k features reported by skew rankings / the flight recorder
    _p("health_topk", 5, int, (), ">0"),
    # PSI above this fires a health.skew alert event (0.25 = the classic
    # "distribution has shifted" rule of thumb)
    _p("health_psi_threshold", 0.25, float, (), ">=0.0"),
    # --- Continual training (lightgbm_tpu/continual/) ---
    # windowed regression detection: mean tick metric over the last
    # continual_window ticks vs the window before; a relative
    # degradation beyond continual_metric_threshold triggers a
    # background retrain, and the same threshold drives the post-swap
    # rollback watchdog for continual_rollback_window ticks
    _p("continual_window", 3, int, (), ">0"),
    _p("continual_metric_threshold", 0.15, float, (), ">=0.0"),
    _p("continual_rollback_window", 3, int, (), ">0"),
    # how many recent tick mini-batches feed a retrain
    _p("continual_buffer_ticks", 8, int, (), ">0"),
    # 0 = inherit num_iterations
    _p("continual_retrain_rounds", 0, int, (), ">=0"),
    # retry/backoff policy around retrains (robustness/retry.py;
    # jitter is SEEDED so fault drills replay bit-exact)
    _p("continual_retrain_attempts", 3, int, (), ">0"),
    _p("continual_backoff_base", 0.05, float, (), ">0.0"),
    _p("continual_backoff_jitter", 0.1, float, (), ">=0.0"),
    # swap gate: a candidate worse than the served model by more than
    # this relative margin on the gate batch is rejected
    _p("continual_swap_margin", 0.0, float, (), ">=0.0"),
    # detection quiet period (ticks) after a swap/rollback/failure
    _p("continual_cooldown", 3, int, (), ">=0"),
    # tick metric: auto (from the objective) | l2 | binary_logloss |
    # multi_logloss — lower is better, computed on the host
    _p("continual_metric", "auto", str),
    # overall retry deadline (seconds of backoff_schedule budget) for a
    # retrain cycle; 0 = attempts alone bound it.  Consumed by
    # robustness/retry.py backoff_schedule(deadline=) — the schedule
    # truncates where the budget runs out, so a retrain degrades to
    # last-good ON TIME instead of sleeping past its usefulness
    _p("continual_retrain_deadline", 0.0, float, (), ">=0.0"),
    # --- Serving service (lightgbm_tpu/serving/) ---
    # `lightgbm_tpu serve`: coalescing micro-batcher + multi-model
    # registry + per-tenant admission control over the ServingEngine.
    # See README "Serving service".
    _p("serve_host", "127.0.0.1", str),
    _p("serve_port", 8080, int, (), ">=0"),
    # resident models at startup: "name=path[,name=path...]"; falls
    # back to input_model= published as "default"
    _p("serve_models", "", str),
    # micro-batcher: flush a coalescing lane at this many pending rows
    # (pick one of the engine's power-of-two buckets) ...
    _p("serve_flush_rows", 256, int, (), ">0"),
    # ... or once its oldest request has waited this long (ms)
    _p("serve_flush_ms", 2.0, float, (), ">=0.0"),
    # bounded per-tenant queue depth (backpressure + ladder shedding)
    _p("serve_queue_depth", 256, int, (), ">0"),
    # per-tenant token bucket: sustained requests/s (0 = unlimited)
    # and burst capacity
    _p("serve_rate_limit", 0.0, float, (), ">=0.0"),
    _p("serve_burst", 64.0, float, (), ">0.0"),
    # default per-request deadline budget (ms; 0 = none): expired work
    # is shed before dispatch, never after
    _p("serve_default_deadline_ms", 0.0, float, (), ">=0.0"),
    # hard per-request row cap (the rate limiter meters REQUESTS, so
    # without a cap one huge-row request would buy unbounded device
    # work for one token); default = the engine's MAX_BUCKET
    _p("serve_max_request_rows", 65536, int, (), ">0"),
    # per-model circuit breaker: consecutive dispatch failures that
    # trip it, and the seeded backoff probe policy (jitter uses `seed`)
    _p("serve_breaker_threshold", 5, int, (), ">0"),
    _p("serve_breaker_base", 0.05, float, (), ">0.0"),
    _p("serve_breaker_jitter", 0.0, float, (), ">=0.0"),
    # registry pack-memory budget (MB; 0 = unlimited): LRU models'
    # engine packs are evicted (lazily re-packed, never re-compiled)
    _p("serve_pack_budget_mb", 0.0, float, (), ">=0.0"),
    # operator endpoints (publish/rollback) auth: when set, requests
    # must carry it as the X-Admin-Token header; when unset, the ops
    # endpoints only answer loopback clients (hot-swapping a serving
    # model from an arbitrary server-side file path is an OPERATOR
    # action, never an open API)
    _p("serve_admin_token", "", str),
    # multi-forest batched execution: when >= 2 tenant models' raw
    # full-range lanes are due in the same pump wave, stack their
    # forests into one padded (forest, tree, node) tensor and serve the
    # whole cohort in ONE compiled dispatch (serving/registry.py cohort
    # packs over ops/forest_tensor.py; compile counts stay pinned per
    # (kind, bucket, cohort-signature)).  Ineligible models (categorical
    # splits, loaded-only, breaker not closed) fall back to per-model
    # dispatch
    _p("serve_cohort", False, bool),
    # minimum due models that form a cohort dispatch (below it the
    # per-model path is already one dispatch each)
    _p("serve_cohort_min", 2, int, (), ">=2"),
    _p("use_quantized_grad", False, bool),
    _p("num_grad_quant_bins", 4, int),
    _p("quant_train_renew_leaf", False, bool),
    _p("stochastic_rounding", True, bool),
    # --- IO / dataset ---
    _p("linear_tree", False, bool, ("linear_trees",)),
    # piece-wise linear trees: "refit" grows the tree by the
    # constant-leaf gain and then fits each leaf's ridge model on the
    # device (models/linear.py); "leafwise_gain" computes split gain
    # over leaf-local linear models inside the tree's search
    # (ops/split_linear.py) so the STRUCTURE itself is PL-aware, and the
    # per-leaf models come out of the winning split candidates -- no
    # extra data pass.  Ineligible configs (models/learner.py
    # ``linear_gain_blockers``) fall back to refit with a warning
    _p("linear_tree_mode", "refit", str),
    _p("max_bin", 255, int, ("max_bins",), ">1"),
    _p("max_bin_by_feature", "", str),
    _p("min_data_in_bin", 3, int, (), ">0"),
    _p("bin_construct_sample_cnt", 200000, int,
       ("subsample_for_bin",), ">0"),
    _p("data_random_seed", 1, int, ("data_seed",)),
    _p("is_enable_sparse", True, bool,
       ("is_sparse", "enable_sparse", "sparse")),
    _p("enable_bundle", True, bool, ("is_enable_bundle", "bundle")),
    _p("use_missing", True, bool),
    _p("zero_as_missing", False, bool),
    _p("feature_pre_filter", True, bool),
    _p("pre_partition", False, bool, ("is_pre_partition",)),
    _p("two_round", False, bool,
       ("two_round_loading", "use_two_round_loading")),
    _p("header", False, bool, ("has_header",)),
    _p("label_column", "", str, ("label",)),
    _p("weight_column", "", str, ("weight",)),
    _p("group_column", "", str,
       ("group", "group_id", "query_column", "query", "query_id")),
    _p("ignore_column", "", str,
       ("ignore_feature", "blacklist")),
    _p("categorical_feature", "", str,
       ("cat_feature", "categorical_column", "cat_column", "categorical_features")),
    _p("forcedbins_filename", "", str),
    _p("save_binary", False, bool, ("is_save_binary", "is_save_binary_file")),
    # dataset construction path (ops/construct.py): "off" = the original
    # per-feature host loops (the oracle); "auto" = vectorized host
    # construction (one batched searchsorted over all features, matmul
    # EFB conflict counts) + direct-to-device (G, N_pad) ingest for
    # training datasets; "on" = auto, plus the host binned matrix is
    # not materialized (recoverable from the device buffer on demand)
    _p("construct_device", "auto", str),
    # free the host binned matrix once the device ingest buffer holds
    # the data — the free_raw_data analog for the packed bin matrix (a
    # raw float copy is only retained under linear_tree, which keeps it)
    _p("free_host_binned", False, bool),
    # out-of-core bin finding (ops/sketch.py): "exact" = the full
    # column sort of the row sample (the oracle); "sketch" =
    # deterministic mergeable per-feature quantile sketches accumulated
    # chunk by chunk — the dense raw matrix never materializes, and
    # rank-sharded construction merges fixed-size sketch states instead
    # of row samples; "auto" = sketch above sketch_row_threshold rows
    _p("bin_construct_mode", "auto", str),
    # sketch capacity per feature: below k distinct values the sketch
    # is exact (mappers bit-identical to the oracle); past it, cells
    # coarsen in power-of-two steps and the CDF error is bounded by the
    # heaviest cell (FeatureSketch.rank_error_bound)
    _p("sketch_k", 8192, int, (), ">=16"),
    _p("sketch_row_threshold", 1000000, int, (), ">0"),
    _p("precise_float_parser", False, bool),
    _p("parser_config_file", "", str),
    # --- Predict ---
    _p("start_iteration_predict", 0, int),
    _p("num_iteration_predict", -1, int),
    _p("predict_raw_score", False, bool,
       ("is_predict_raw_score", "predict_rawscore", "raw_score")),
    _p("predict_leaf_index", False, bool,
       ("is_predict_leaf_index", "leaf_index")),
    _p("predict_contrib", False, bool,
       ("is_predict_contrib", "contrib")),
    _p("predict_disable_shape_check", False, bool),
    # serving traversal kernel (models/serving.py / ops/forest_tensor.py):
    # "layered" reformulates packed-forest traversal as per-depth dense
    # gather+compare ops with a FIXED trip count (= max tree depth, a
    # pack-time host constant) and quantized u8/u16 node planes — no
    # data-dependent while_loop in the lowered program; "loop" is the
    # stacked while-loop oracle (ops/predict.py); "auto" serves layered
    # whenever the forest fits the quantized planes and unroll ceiling,
    # falling back to the loop oracle otherwise.  The f32 layered path
    # is bit-identical to the loop oracle (tests/test_forest_tensor.py)
    _p("predict_kernel", "auto", str),
    # store packed leaf-value planes in bf16 (accumulation stays f32):
    # halves the leaf gather traffic at a ~3-decimal-digit leaf
    # precision cost — opt-in, OFF keeps bit-parity with the oracle
    _p("predict_bf16_leaves", False, bool),
    _p("pred_early_stop", False, bool),
    _p("pred_early_stop_freq", 10, int),
    _p("pred_early_stop_margin", 10.0, float),
    _p("output_result", "LightGBM_predict_result.txt", str,
       ("predict_result", "prediction_result", "predict_name",
        "prediction_name", "pred_name", "name_pred")),
    # --- Convert ---
    _p("convert_model_language", "", str),
    _p("convert_model", "gbdt_prediction.cpp", str,
       ("convert_model_file",)),
    # --- Objective ---
    _p("objective_seed", 5, int),
    _p("num_class", 1, int, ("num_classes",), ">0"),
    _p("is_unbalance", False, bool,
       ("unbalance", "unbalanced_sets")),
    _p("scale_pos_weight", 1.0, float, (), ">0.0"),
    _p("sigmoid", 1.0, float, (), ">0.0"),
    _p("boost_from_average", True, bool),
    _p("reg_sqrt", False, bool),
    _p("alpha", 0.9, float, (), ">0.0"),
    _p("fair_c", 1.0, float, (), ">0.0"),
    _p("poisson_max_delta_step", 0.7, float, (), ">0.0"),
    _p("tweedie_variance_power", 1.5, float, (), "1.0<=x<2.0"),
    _p("lambdarank_truncation_level", 30, int, (), ">0"),
    _p("lambdarank_norm", True, bool),
    _p("label_gain", "", str),
    _p("lambdarank_position_bias_regularization", 0.0, float, (), ">=0.0"),
    # --- Metric ---
    _p("metric", "", str, ("metrics", "metric_types")),
    _p("metric_freq", 1, int, ("output_freq",), ">0"),
    _p("is_provide_training_metric", False, bool,
       ("training_metric", "is_training_metric", "train_metric")),
    _p("eval_at", "1,2,3,4,5", str,
       ("ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at")),
    _p("multi_error_top_k", 1, int, (), ">0"),
    _p("auc_mu_weights", "", str),
    # TPU extension: gather score/label pairs across ranks for an EXACT
    # global AUC under data-parallel row sharding (default stays the
    # reference-shaped per-rank weighted mean, which warns once)
    _p("distributed_exact_auc", False, bool),
    # --- Network ---
    _p("num_machines", 1, int, ("num_machine",), ">0"),
    _p("local_listen_port", 12400, int, ("local_port", "port"), ">0"),
    _p("time_out", 120, int, (), ">0"),
    _p("machine_list_filename", "", str,
       ("machine_list_file", "machine_list", "mlist")),
    _p("machines", "", str, ("workers", "nodes")),
    # --- Device ---
    _p("gpu_platform_id", -1, int),
    _p("gpu_device_id", -1, int),
    _p("gpu_use_dp", False, bool),
    _p("num_gpu", 1, int, (), ">0"),
    # --- TPU-specific (new in this framework) ---
    # On the GPU (lightgbm_tpu_torch) each knob below keeps its name so one
    # params dict trains in both packages; the comment's last line says
    # what it means here.  Values the port has no path for raise
    # NotImplementedError (_UNSUPPORTED).
    _p("tpu_hist_dtype", "float32", str),       # float32 | bfloat16_pair
    # GPU: float32 and bfloat16_pair both run the same exact histograms:
    # f32 grad/hess summed in 64-bit fixed point on the card (the TPU's
    # bf16 hi/lo pair is a TPU matmul lever with no counterpart here).
    _p("tpu_hist_kernel", "xla", str),          # xla | pallas
    # GPU: xla and pallas both run the hand-written leaf-histogram
    # kernel csrc/leaf_hist.cu on the tpu_megakernel=off path (the mega
    # path builds its histograms inside csrc/split_mega.cu).
    # per-leaf histogram state: "auto" = lane-flattened state updated in
    # place by the Pallas RMW kernel (ops/hist_state_pallas.py) when the
    # fast serial path is active; "xla" = (L+1, G, B, 2) dynamic-slice
    # state (the fallback and the A/B baseline)
    # GPU: auto and xla both keep a (leaves, 2, G, Bp) int64 state of exact
    # fixed-point sums on the tpu_megakernel=off path, updated by the state
    # epilogue of csrc/leaf_hist.cu (ops/hist_state.py:leaf_hist_rmw).
    _p("tpu_hist_state", "auto", str),
    # measurement-only: duplicate one component inside the compiled tree
    # loop with a runtime-opaque select so tools/ab_bench.py can read its
    # IN-CONTEXT cost as the paired e2e delta ("" | "hist" | "search")
    # GPU: not supported ("" only).
    _p("tpu_ab_double", "", str),
    # GPU: pallas only -- the hand-written partition (csrc/partition.cu,
    # or the one inside csrc/split_mega.cu on the mega path).
    _p("tpu_partition_kernel", "pallas", str),  # pallas | xla
    # split mega-kernel: partition + BOTH children's histograms in one
    # Pallas program per split (ops/split_megakernel_pallas.py) — no
    # parent-histogram read, no subtraction trick, no (L+1)-slot
    # histogram state in the while-loop carry.  "auto" probes the kernel
    # on TPU and falls back to the current split path; "pallas" forces
    # the attempt; "xla" runs the same math as plain XLA ops (the
    # correctness oracle, any backend); "off" disables
    # GPU: auto and pallas run csrc/split_mega.cu per split; off runs the
    # histogram-subtraction path (csrc/partition.cu, then csrc/leaf_hist.cu
    # for the smaller child and, in the same launch, parent minus smaller
    # in the histogram state); xla
    # is not supported.
    _p("tpu_megakernel", "auto", str),
    # frontier-batched tree growth: grow the top-K gain leaves of the
    # current frontier per while-loop step instead of 1, amortizing the
    # per-split fixed bookkeeping cost ~K-fold (models/learner.py; the
    # oracle-order replay keeps trained trees BIT-identical to the K=1
    # learner, including at the num_leaves budget boundary).  "auto"
    # engages K=4 on TPU backends when the plain serial path is active
    # and stays at 1 elsewhere; an explicit integer K forces batching on
    # any backend (falls back to 1 with a warning when forced splits,
    # monotone constraints, CEGB, extra_trees, feature_fraction_bynode,
    # interaction constraints or a parallel tree learner are active)
    # GPU: K > 1 grows up to K leaves a step on the mega path, trees
    # bit-identical to K=1 (ops/frontier.py; each step one IF node of the
    # tree's CUDA graph); auto is models/learner.py AUTO_FRONTIER_K on the
    # card and 1 on the CPU; tpu_megakernel=off falls back to 1 with a
    # warning, as the JAX package's Pallas pair search without the mega
    # kernel does.
    _p("tpu_frontier_k", "auto", str),
    # radix-4 compaction network in the partition/mega kernels: half the
    # roll-network steps of the binary network (bit-identical layouts;
    # an instruction-budget lever — see PERF.md round 6)
    # GPU: no effect; the card's partition has no roll network.
    _p("tpu_compact_radix", False, bool),
    # run the Pallas kernels through the interpreter on any backend
    # (testing/debug: enables the kernel paths off-TPU; SLOW)
    # GPU: no effect; device_type=cpu runs the kernels' plain versions.
    _p("tpu_kernel_interpret", False, bool),
    # rows per partition/histogram chunk; 4096 measured best end-to-end
    # on v5e (round 3: fixed cost 15.9 -> 12.1 ms/iter vs 8192 at equal
    # slope — smaller per-split padding waste).  "auto" consults the
    # BENCH_history.jsonl trajectory for a same-fingerprint chunk-sweep
    # winner before falling back to 4096 (ops/chunkpolicy.py); also the
    # SEED of the leaf-size-adaptive menu below
    # GPU: sets only the row padding of the (G, N_pad) buffers; the
    # kernels pick their own tiles.
    _p("tpu_row_chunk", "4096", str),
    # leaf-size-adaptive chunk policy (ops/chunkpolicy.py): per-leaf
    # histogram/partition passes pick their chunk width from a bounded
    # static menu seeded by tpu_row_chunk, so small leaves stop paying
    # the worst-case padded chunk (68% of the CPU iteration, PERF.md
    # round 12) while trees stay BIT-identical to the fixed grid.
    # "auto" = adaptive in the small-leaf regime (or per a measured
    # same-fingerprint chunk-sweep verdict) on the plain XLA serial
    # path; "fixed" = the base grid everywhere; "adaptive" = force on
    # GPU: no effect; the histogram kernels size their chunks per leaf.
    _p("tpu_chunk_policy", "auto", str),
    # ride the rowid row inside the spare packed-bin bytes when G <= G32-4
    # (one fewer payload sublane through the partition roll networks)
    # GPU: no effect; the partition moves all 8 payload rows as words.
    _p("tpu_pack_rowid", False, bool),
    # disable the fused single-program iteration (A/B + debugging; the
    # eager per-stage dispatch path is the fallback)
    # GPU: False takes the eager iteration (models/boosting.py: the
    # bag, GOSS and quantization drawn in original row order, JAX's
    # eager draws), as DART, RF and GOSS with a renewing objective do.
    _p("tpu_fused_iteration", True, bool),
    # data-parallel histogram sync: "scatter" = ReduceScatter ownership
    # (psum_scatter + per-device feature ownership + winner election),
    # preserving the reference's placement decision
    # (data_parallel_tree_learner.cpp:282-296) — each histogram element
    # crosses the wire once instead of ndev times; "psum" = full-hist
    # allreduce (the round-4 behavior)
    # GPU: no effect; the port has the serial learner only.
    _p("tpu_data_hist_sync", "scatter", str),
    # GPU: tpu_feature_block, tpu_min_bucket_log2 and tpu_donate_state
    # have no effect (TPU blocking, bucketing and XLA buffer donation).
    _p("tpu_feature_block", 64, int, (), ">0"),  # feature groups per histogram block
    _p("tpu_min_bucket_log2", 10, int, (), ">=0"),  # smallest partition bucket
    _p("tpu_donate_state", True, bool),
]

_PARAM_BY_NAME: Dict[str, _Param] = {p.name: p for p in _PARAMS}
_ALIAS2NAME: Dict[str, str] = {}
for _param in _PARAMS:
    _ALIAS2NAME[_param.name] = _param.name
    for _a in _param.aliases:
        _ALIAS2NAME.setdefault(_a, _param.name)

_OBJECTIVE_ALIASES = {
    # objective-string aliases (reference: config.cpp ParseObjectiveAlias)
    "regression": "regression", "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "xentropy": "cross_entropy", "cross_entropy": "cross_entropy",
    "xentlambda": "cross_entropy_lambda", "cross_entropy_lambda": "cross_entropy_lambda",
    "mean_absolute_percentage_error": "mape", "mape": "mape",
    "none": "none", "null": "none", "custom": "none", "na": "none",
    "binary": "binary", "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile", "gamma": "gamma", "tweedie": "tweedie",
    "lambdarank": "lambdarank", "rank_xendcg": "rank_xendcg",
    "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg", "xendcg_mart": "rank_xendcg",
}

_METRIC_ALIASES = {
    # reference: config.cpp ParseMetricAlias
    "null": "", "none": "", "na": "custom",
    "mean_squared_error": "l2", "mse": "l2", "regression_l2": "l2", "regression": "l2",
    "l2_root": "rmse", "root_mean_squared_error": "rmse",
    "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    "xendcg": "ndcg", "xe_ndcg": "ndcg", "xe_ndcg_mart": "ndcg", "xendcg_mart": "ndcg",
    "mean_average_precision": "map",
    "multiclass": "multi_logloss", "softmax": "multi_logloss",
    "multiclassova": "multi_logloss", "multiclass_ova": "multi_logloss",
    "ova": "multi_logloss", "ovr": "multi_logloss",
    "xentropy": "xentropy", "cross_entropy": "xentropy",
    "xentlambda": "xentlambda", "cross_entropy_lambda": "xentlambda",
    "kldiv": "kullback_leibler", "kullback_leibler": "kullback_leibler",
    "mean_absolute_percentage_error": "mape", "mape": "mape",
}


def _coerce(param: _Param, value: Any) -> Any:
    if param.typ is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)):
            return bool(value)
        s = str(value).strip().lower()
        if s in ("true", "1", "+", "yes", "on"):
            return True
        if s in ("false", "0", "-", "no", "off"):
            return False
        log.fatal("Invalid boolean value %s for parameter %s", value, param.name)
    if param.typ is int:
        if value is None:
            return None
        return int(float(value))
    if param.typ is float:
        return float(value)
    return str(value)


def _check_value(param: _Param, v: Any) -> None:
    if param.check is None or v is None or param.typ is str:
        return
    c = param.check
    ok = True
    if "<=x<" in c or "<x<=" in c or "<=x<=" in c or "<x<" in c:
        import re
        m = re.match(r"([-\d.eE+]+)(<=|<)x(<=|<)([-\d.eE+]+)", c)
        lo, lop, hip, hi = float(m.group(1)), m.group(2), m.group(3), float(m.group(4))
        ok = (lo <= v if lop == "<=" else lo < v) and (v <= hi if hip == "<=" else v < hi)
    elif c.startswith(">="):
        ok = v >= float(c[2:])
    elif c.startswith(">"):
        ok = v > float(c[1:])
    elif c.startswith("<="):
        ok = v <= float(c[2:])
    elif c.startswith("<"):
        ok = v < float(c[1:])
    if not ok:
        log.fatal("Parameter %s should satisfy %s, got %s", param.name, c, v)


DEFAULT_ROW_CHUNK = 4096


def parse_row_chunk(spec) -> Optional[int]:
    """``tpu_row_chunk``: an integer, or ``auto`` (None) for the default."""
    s = str(spec).strip().lower()
    if s in ("auto", ""):
        return None
    try:
        v = int(float(s))
    except ValueError:
        raise ValueError(
            f"tpu_row_chunk must be 'auto' or a positive integer, "
            f"got {spec!r}")
    if v <= 0:
        raise ValueError(f"tpu_row_chunk must be positive, got {v}")
    return v


def _off(v) -> bool:
    return v in (None, "", 0, 0.0, False) or str(v).strip().lower() in (
        "", "none", "off", "0", "false")


def _monotone_on(c) -> bool:
    """A ``monotone_constraints`` value with a nonzero entry."""
    return not _off(c.monotone_constraints) and any(
        v.strip() not in ("0", "") for v in
        str(c.monotone_constraints).strip("()[]").split(","))


_PORTED_OBJECTIVES = (
    "regression", "regression_l1", "huber", "fair", "poisson", "quantile",
    "mape", "gamma", "tweedie", "binary", "multiclass", "multiclassova",
    "cross_entropy", "cross_entropy_lambda", "lambdarank", "rank_xendcg",
    "none")
MULTICLASS_OBJECTIVES = ("multiclass", "multiclassova")


# Params whose non-default values select a path this port does not have
# yet: (param, predicate on the resolved Config that is True when the
# value is unsupported[, what it is refused with]).  Every entry raises
# NotImplementedError naming the param; nothing silently takes another
# path.
_UNSUPPORTED = [
    ("objective", lambda c: c.objective not in _PORTED_OBJECTIVES),
    ("boosting", lambda c: c.boosting not in ("gbdt", "dart", "rf")),
    ("data_sample_strategy", lambda c: c.data_sample_strategy
     not in ("bagging", "goss")),
    ("feature_fraction_bynode", lambda c: c.feature_fraction_bynode < 1.0),
    ("extra_trees", lambda c: bool(c.extra_trees)),
    # monotone constraints train by the basic and intermediate methods;
    # advanced needs per-threshold bounds in the pair search
    ("monotone_constraints_method",
     lambda c: c.monotone_constraints_method == "advanced"
     and _monotone_on(c)),
    ("interaction_constraints", lambda c: not _off(c.interaction_constraints)),
    ("forcedsplits_filename", lambda c: not _off(c.forcedsplits_filename)),
    ("forcedbins_filename", lambda c: not _off(c.forcedbins_filename)),
    ("cegb_penalty_split", lambda c: c.cegb_penalty_split > 0.0),
    ("cegb_penalty_feature_lazy",
     lambda c: not _off(c.cegb_penalty_feature_lazy)),
    ("cegb_penalty_feature_coupled",
     lambda c: not _off(c.cegb_penalty_feature_coupled)),
    ("path_smooth", lambda c: c.path_smooth > 0.0),
    ("feature_contri", lambda c: not _off(c.feature_contri)
     and any(float(v) != 1.0 for v in
             str(c.feature_contri).replace(" ", "").split(",") if v)),
    ("tree_learner", lambda c: c.tree_learner != "serial"),
    # reference: config.cpp CheckParamConflict -- one class but for the
    # multiclass objectives, which need two or more (a custom objective,
    # ``none``, takes any)
    ("num_class", lambda c: (c.num_class < 2) if c.objective
     in MULTICLASS_OBJECTIVES else (c.num_class != 1
                                    and c.objective != "none"),
     "objective"),
    ("bin_construct_mode", lambda c: str(c.bin_construct_mode).lower()
     not in ("auto", "exact")),
    ("nonfinite_policy", lambda c: str(c.nonfinite_policy).lower() != "none"),
    ("checkpoint_dir", lambda c: not _off(c.checkpoint_dir)),
    ("checkpoint_resume", lambda c: bool(c.checkpoint_resume)),
    ("telemetry", lambda c: str(c.telemetry).lower() != "off"),
    ("health", lambda c: str(c.health).lower() != "off"),
    ("tpu_megakernel", lambda c: str(c.tpu_megakernel).strip().lower()
     not in ("auto", "pallas", "", "off")),
    ("tpu_partition_kernel",
     lambda c: str(c.tpu_partition_kernel).lower() != "pallas"),
    ("tpu_hist_kernel", lambda c: str(c.tpu_hist_kernel).lower()
     not in ("xla", "pallas")),
    ("tpu_hist_state", lambda c: str(c.tpu_hist_state).lower()
     not in ("auto", "xla")),
    ("tpu_hist_dtype", lambda c: str(c.tpu_hist_dtype).lower()
     not in ("float32", "bfloat16_pair")),
    ("tpu_ab_double", lambda c: not _off(c.tpu_ab_double)),
    ("pred_early_stop", lambda c: bool(c.pred_early_stop)),
    ("device_type", lambda c: str(c.device_type).lower()
     not in ("cuda", "gpu", "cpu")),
]


_WARNED_UNKNOWN: set = set()


def reset_unknown_param_warnings() -> None:
    """Open a fresh unknown-parameter warning scope.

    Called at every top-level ``train()``/``cv()`` entry: within one call
    Config is legitimately rebuilt several times from the same raw params
    (Dataset, Booster, engine) and the warning must fire once — but a
    typo'd key in a LATER, unrelated training session in the same process
    must warn again, not be swallowed by a process-lifetime set."""
    _WARNED_UNKNOWN.clear()


class Config:
    """Resolved training configuration (reference: include/LightGBM/config.h)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None, **kwargs):
        merged: Dict[str, Any] = {}
        if params:
            merged.update(params)
        merged.update(kwargs)
        # canonicalize aliases; earlier (canonical) names win on conflict, like
        # the reference KeyAliasTransform keeping the first-priority alias.
        resolved: Dict[str, Any] = {}
        self._unknown: Dict[str, Any] = {}
        for key, value in merged.items():
            k = str(key).strip().lower().replace("-", "_")
            # list/tuple values join to comma-separated strings, like the
            # reference python package's _param_dict_to_str (basic.py:303)
            if isinstance(value, (list, tuple)):
                value = ",".join(str(v) for v in value)
            name = _ALIAS2NAME.get(k)
            if name is None:
                self._unknown[k] = value
                continue
            if name in resolved and k != name:
                continue  # canonical key already set; alias loses
            resolved[name] = value
        for p in _PARAMS:
            if p.name in resolved and resolved[p.name] is not None:
                v = _coerce(p, resolved[p.name])
                _check_value(p, v)
                setattr(self, p.name, v)
            else:
                setattr(self, p.name, p.default)
        self._post_process()
        # reference: Config surfaces unrecognized keys instead of
        # silently dropping them (include/LightGBM/config.h:1242
        # "Unknown parameter: %s"); a typo'd key (num_leafs) must not
        # train silently with defaults.  Deduped per warning scope (one
        # top-level train()/cv() call, see reset_unknown_param_warnings):
        # one train call legitimately rebuilds Config several times
        # (Dataset, Booster, engine) from the same raw params.
        for k in self._unknown:
            if k not in _WARNED_UNKNOWN:
                _WARNED_UNKNOWN.add(k)
                log.warning("Unknown parameter: %s", k)

    # -- derived state (reference: Config::Set, src/io/config.cpp) --
    def _post_process(self) -> None:
        # str-typed numeric-or-auto knobs keep config-time validation
        # (a typo must fail HERE with a clear message, not surface as a
        # swallowed exception in dataset/learner construction)
        try:
            parse_row_chunk(self.tpu_row_chunk)
        except ValueError as exc:
            log.fatal("%s", exc)
        if str(self.tpu_chunk_policy).strip().lower() not in (
                "auto", "fixed", "adaptive", ""):
            log.warning("unknown tpu_chunk_policy=%r; treating as auto",
                        self.tpu_chunk_policy)
        ltm = str(self.linear_tree_mode).strip().lower() or "refit"
        if ltm not in ("refit", "leafwise_gain"):
            log.warning("unknown linear_tree_mode=%r; treating as refit",
                        self.linear_tree_mode)
            ltm = "refit"
        self.linear_tree_mode = ltm
        self.objective = _OBJECTIVE_ALIASES.get(
            str(self.objective).lower(), str(self.objective).lower())
        # boosting aliases; "goss" boosting folds into gbdt + goss strategy
        b = str(self.boosting).lower()
        b = {"gbrt": "gbdt", "gbm": "gbdt", "random_forest": "rf"}.get(b, b)
        if b == "goss":
            b = "gbdt"
            self.data_sample_strategy = "goss"
        self.boosting = b
        if self.seed is not None:
            # reference: config.cpp uses seed to derive the other seeds
            base = int(self.seed)
            self.data_random_seed = base + 1
            self.bagging_seed = base + 3
            self.drop_seed = base + 4
            self.feature_fraction_seed = base + 2
            self.extra_seed = base + 6
            self.objective_seed = base + 5
        else:
            self.seed = 0
        # metric list
        raw_metrics = [m.strip().lower() for m in str(self.metric).split(",") if m.strip()]
        self.metric_list: List[str] = []
        for m in raw_metrics:
            m = _METRIC_ALIASES.get(m, m)
            if m and m not in self.metric_list:
                self.metric_list.append(m)
        self.eval_at_list = [int(x) for x in str(self.eval_at).split(",")
                             if x.strip()]
        # tree_learner aliases (reference: config.cpp Config::Set)
        tl = str(self.tree_learner).lower()
        tl = {"serial": "serial", "feature": "feature", "feature_parallel": "feature",
              "data": "data", "data_parallel": "data", "voting": "voting",
              "voting_parallel": "voting"}.get(tl, tl)
        self.tree_learner = tl
        if self.verbosity is not None:
            log.set_verbosity(self.verbosity)

    # ------------------------------------------------------------------
    def check_supported(self) -> None:
        """Raise NotImplementedError naming the first param whose value
        selects a path this port does not have."""
        for name, bad, *also in _UNSUPPORTED:
            if bad(self):
                what = "".join(f" with {a}={getattr(self, a)!r}"
                               for a in also)
                raise NotImplementedError(
                    f"lightgbm_tpu_torch does not support "
                    f"{name}={getattr(self, name)!r}{what} yet")

    def torch_device(self):
        """The ``torch.device`` this config trains and predicts on:
        ``cuda`` (the default; raises without a card) or ``cpu``."""
        import torch
        kind = str(self.device_type).strip().lower()
        if kind in ("cuda", "gpu"):
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "device_type=cuda but torch.cuda.is_available() is "
                    "False; pass device_type='cpu' to run on the CPU")
            return torch.device("cuda", torch.cuda.current_device())
        if kind == "cpu":
            return torch.device("cpu")
        raise NotImplementedError(
            f"lightgbm_tpu_torch does not support device_type={kind!r}")

    # ------------------------------------------------------------------
    def save_to_string(self) -> str:
        """Model-file `parameters:` section (reference: SaveMembersToString)."""
        lines = []
        for p in _PARAMS:
            v = getattr(self, p.name)
            if isinstance(v, bool):
                v = int(v)
            lines.append(f"[{p.name}: {v}]")
        return "\n".join(lines)

    @staticmethod
    def canonical_name(key: str) -> Optional[str]:
        return _ALIAS2NAME.get(str(key).strip().lower().replace("-", "_"))

