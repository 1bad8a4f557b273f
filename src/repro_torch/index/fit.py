"""Declarative SLO-driven index construction: ``FitSpec`` -> ``IndexPlan`` ->
:func:`open_index`.

The paper's headline knob is *not* ``error`` -- it is the SLO (Sec. 6): "a
cost model that helps determine an appropriate error parameter given either
(1) a lookup latency requirement (e.g., 500ns) or (2) a storage budget
(e.g., 100MB)".  This module makes that the front door of the library.
Instead of hand-picking ``error``, shard counts, and dispatch thresholds, a
caller writes down what they *want*:

    spec = FitSpec(latency_budget_ns=500.0)          # or storage_budget_bytes
    svc = open_index(keys, spec)                     # IndexService or sharded
    svc.insert(k); svc.publish(); svc.lookup(q)

and the planner resolves it through the Sec. 6 cost model
(:func:`repro_torch.core.cost_model.learn_segments_fn` +
``choose_error_for_latency``/``choose_error_for_space``) into a concrete,
auditable :class:`IndexPlan`: the error parameter, the shard count (from
insert-rate and key-count heuristics), the default engine backend (from the
expected batch-size distribution), and the cost-model-calibrated
``DispatchEngine`` tier thresholds (:func:`repro_torch.core.cost_model.
dispatch_thresholds` -- the batch sizes where the modeled per-tier latency
curves cross).  ``IndexPlan.explain()`` reports the predicted latency/size of
every candidate error so the choice can be reviewed before anything is built.

The split is deliberate: ``plan()`` is pure (numpy + the cost model, no torch,
no construction), so a plan can be computed offline from a key sample,
serialized alongside the spec (``FitSpec.to_json``), and reviewed; only
:func:`open_index` builds serving state.  Both ``IndexService`` and
``ShardedIndexService`` also accept a plan directly (``from_plan`` /
``plan=``), and their raw-knob constructors now delegate through a trivially
resolved plan, so "what configuration is this service actually running?" has
one answer: ``svc.plan``.

An infeasible budget raises :class:`InfeasibleSpecError` naming the tightest
achievable value instead of silently degrading.

Port of ``repro.index.fit`` (host code, copied).  ``hardware`` is ``"cpu"``
(the paper's model) or ``"gpu"`` (the card's :class:`GPUCostParams`); the
reference's ``"tpu"`` profile does not carry over.  Backend names follow the
port: the reference's ``pallas`` is ``cuda`` and ``xla-bisect`` is
``torch-bisect``; ``FitSpec.from_json`` / ``IndexPlan.from_json`` map them when
they read the reference's JSON.  Raw-knob plans default to the ``cuda``
backend, so services serve on the card unless told otherwise; a device plan
opens the port's ``DeviceShardedService``, whose rows sit on ``cuda:0 ..
D-1`` unless ``open_index`` is given ``devices=[...]``.
"""
from __future__ import annotations

import dataclasses
import json
import math

import numpy as np

from repro_torch.core.cost_model import (CostParams, GPUCostParams,
                                         choose_error_for_latency,
                                         choose_error_for_space,
                                         choose_exchange, dispatch_thresholds,
                                         exchange_crossover_batch, latency_ns,
                                         latency_ns_gpu, learn_segments_fn,
                                         range_latency_ns,
                                         range_latency_ns_gpu,
                                         scan_ns_per_row_gpu, size_bytes)

# Default error sweep: the paper's Sec. 7 evaluation range (powers of two so
# learn_segments_fn interpolates log-log between measured segmentations).
DEFAULT_CANDIDATE_ERRORS: tuple[int, ...] = (
    8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)

# Shard-count heuristics (plan() docstring explains both):
_SHARD_TARGET_KEYS = 2_000_000       # per-shard publish stays tens of ms
_SHARD_TARGET_INSERTS_PER_S = 50_000  # one writer absorbs this much traffic
_MAX_PLANNED_SHARDS = 64

# The reference's backend names -> the port's (JSON read from ``repro``).
_PORT_BACKENDS = {"pallas": "cuda", "xla-bisect": "torch-bisect",
                  "xla-window": "torch-window"}


class InfeasibleSpecError(ValueError):
    """No candidate error satisfies the spec's budget.

    Carries the objective (``"latency"`` / ``"space"``), the requested
    budget, and the tightest achievable value over the candidate sweep so
    callers can relax the spec programmatically."""

    def __init__(self, objective: str, budget: float, tightest: float,
                 unit: str, note: str = ""):
        self.objective = objective
        self.budget = budget
        self.tightest = tightest
        super().__init__(
            f"no candidate error satisfies the {objective} budget "
            f"{budget:g} {unit}; the tightest achievable {objective} over "
            f"the candidate sweep is {tightest:g} {unit} -- relax the "
            f"budget to at least that, widen candidate_errors, or switch "
            f"objective{note}")


@dataclasses.dataclass(frozen=True)
class FitSpec:
    """What the caller wants from the index, not how to build it.

    Exactly one of the three objectives must be set:

    * ``latency_budget_ns`` -- Sec. 6.1: the smallest index meeting this
      per-lookup latency requirement.
    * ``storage_budget_bytes`` -- Sec. 6.2: the fastest index whose segment
      metadata fits this budget.
    * ``error`` -- expert escape hatch: pin the error parameter directly
      (the planner still resolves shards/backend/thresholds around it).

    Workload hints (all optional) steer the rest of the plan:

    * ``batch_sizes`` -- a sample of expected lookup batch sizes; picks the
      default backend (all-small -> numpy, all-large -> cuda, mixed ->
      dispatch).
    * ``insert_rate`` -- expected inserts/second; drives the shard count
      (independent per-shard epoch streams absorb write traffic) and the
      auto-publish cadence.
    * ``write_heavy`` -- tri-state write-mode override.  ``True`` plans the
      LSM tiered write path (``repro_torch.index.lsm``: memtable ->
      learned runs -> background compaction) regardless of the buffer math;
      ``False`` pins the paper's in-place Alg. 4 buffer path (and an error=1
      plan under inserts stays a loud failure); ``None`` (default) lets the planner
      decide -- it falls back to LSM exactly when the resolved error leaves
      no room for an insert buffer but the spec promises write traffic.
    * ``duplicate_density`` -- expected fraction of duplicated keys in
      [0, 1); caps the shard count (duplicate-safe cuts need at least one
      distinct key run per shard).
    * ``range_fraction`` -- expected fraction of queries that are range
      scans (in [0, 1]); folds the range-scan cost term (fixed predecessor
      cost + ``range_scan_rows`` x per-row scan marginal) into every
      candidate's predicted latency and into the dispatch-threshold
      crossings, so scan-heavy workloads plan a coarser error / earlier
      device dispatch than point-only ones.
    * ``range_scan_rows`` -- expected rows returned per range scan (the
      selectivity hint the scan term multiplies).
    * ``key_sample`` -- a representative key sample, so a plan can be
      computed (and the spec shipped in a config file) before the full key
      set exists; ``plan(None, spec)`` uses it.  ``n_keys_hint`` scales the
      sample back up to the production key count for the shard heuristic.
    * ``device_count`` -- serve from a device mesh: the plan pins one shard
      per device (``backend="device"``: ``index/device_plane.py``'s
      ``DeviceShardedService``, which ``open_index`` opens) and scores the
      collective exchange strategy (allgather vs bucketed all_to_all) via
      the cost model on the expected batch sizes.  Incompatible with
      ``write_heavy=True`` (the LSM plane is host-resident).

    ``hardware`` selects the latency model: ``"cpu"`` is the paper's Eq. 1
    cache-miss model (:class:`CostParams`), ``"gpu"`` the card's roofline
    model (:class:`GPUCostParams`); the matching params field overrides the
    defaults.  ``to_json``/``from_json`` round-trip the whole spec for
    config-file-driven serving; ``from_json`` also reads the reference's
    JSON, whose TPU profile (``tpu_params``) it drops.
    """

    latency_budget_ns: float | None = None
    storage_budget_bytes: float | None = None
    error: int | None = None
    # workload hints
    batch_sizes: tuple[int, ...] | None = None
    insert_rate: float = 0.0
    write_heavy: bool | None = None
    duplicate_density: float = 0.0
    range_fraction: float = 0.0
    range_scan_rows: int = 256
    key_sample: tuple[float, ...] | None = None
    n_keys_hint: int | None = None
    device_count: int | None = None
    # hardware profile
    hardware: str = "cpu"
    cpu_params: CostParams = CostParams()
    gpu_params: GPUCostParams = GPUCostParams()
    # planner knobs
    candidate_errors: tuple[int, ...] = DEFAULT_CANDIDATE_ERRORS
    segment_sample: int | None = 200_000

    def __post_init__(self):
        objectives = {"latency_budget_ns": self.latency_budget_ns,
                      "storage_budget_bytes": self.storage_budget_bytes,
                      "error": self.error}
        set_names = [k for k, v in objectives.items() if v is not None]
        if len(set_names) != 1:
            given = ", ".join(set_names) if set_names else "none"
            raise ValueError(
                "FitSpec needs exactly one objective: pass latency_budget_ns"
                " (a lookup SLO, e.g. 500.0), OR storage_budget_bytes (an "
                "index size budget, e.g. 100e6), OR error (expert: pin the "
                f"paper's error parameter); got {given}")
        if self.latency_budget_ns is not None and self.latency_budget_ns <= 0:
            raise ValueError(f"latency_budget_ns must be > 0, got "
                             f"{self.latency_budget_ns!r} (it is a per-lookup"
                             " budget in nanoseconds)")
        if self.storage_budget_bytes is not None \
                and self.storage_budget_bytes <= 0:
            raise ValueError(f"storage_budget_bytes must be > 0, got "
                             f"{self.storage_budget_bytes!r} (it is an index-"
                             "metadata budget in bytes)")
        if self.error is not None and self.error < 1:
            raise ValueError(f"error must be >= 1, got {self.error!r}")
        if self.insert_rate < 0:
            raise ValueError(f"insert_rate must be >= 0, got "
                             f"{self.insert_rate!r}")
        if self.write_heavy is not None \
                and not isinstance(self.write_heavy, bool):
            raise ValueError(f"write_heavy must be True, False or None (let "
                             f"the planner decide), got {self.write_heavy!r}")
        if not 0.0 <= self.duplicate_density < 1.0:
            raise ValueError(f"duplicate_density must be in [0, 1), got "
                             f"{self.duplicate_density!r}")
        if not 0.0 <= self.range_fraction <= 1.0:
            raise ValueError(f"range_fraction must be in [0, 1], got "
                             f"{self.range_fraction!r} (it is the expected "
                             "fraction of queries that are range scans)")
        if self.range_scan_rows < 1:
            raise ValueError(f"range_scan_rows must be >= 1, got "
                             f"{self.range_scan_rows!r} (expected rows per "
                             "range scan)")
        if self.device_count is not None and self.device_count < 1:
            raise ValueError(f"device_count must be >= 1, got "
                             f"{self.device_count!r} (the number of devices "
                             "the plan fans the shard layout over)")
        if self.device_count is not None and self.write_heavy:
            raise ValueError(
                "device_count is incompatible with write_heavy=True: the LSM "
                "tiered write plane is host-resident, while a device plan "
                "serves from device-installed snapshots; drop one of the two "
                "hints")
        if self.key_sample is not None and len(self.key_sample) == 0:
            raise ValueError("key_sample must be non-empty when given (pass "
                             "None to require keys at plan time)")
        if self.batch_sizes is not None and (
                len(self.batch_sizes) == 0
                or any(b < 1 for b in self.batch_sizes)):
            raise ValueError("batch_sizes must be a non-empty sequence of "
                             f"positive batch sizes, got {self.batch_sizes!r}")
        if self.hardware == "tpu":
            raise ValueError("hardware='tpu' is the JAX package's profile and "
                             "does not carry over to the port; use 'gpu' (the "
                             "CUDA card's GPUCostParams) or 'cpu'")
        if self.hardware not in ("cpu", "gpu"):
            raise ValueError(f"hardware must be 'cpu' or 'gpu', got "
                             f"{self.hardware!r}")
        if len(self.candidate_errors) == 0 \
                or any(e < 1 for e in self.candidate_errors):
            raise ValueError("candidate_errors must be a non-empty sequence "
                             "of errors >= 1")
        if self.segment_sample is not None and self.segment_sample < 1:
            raise ValueError(f"segment_sample must be >= 1 (or None for the "
                             f"full key set), got {self.segment_sample!r}")
        # normalize sequence fields to tuples of plain Python scalars (numpy
        # arrays and np.int64/np.float64 elements are natural inputs here)
        # so to_json never trips on non-serializable types and
        # from_json(to_json(s)) == s holds structurally
        if self.batch_sizes is not None:
            object.__setattr__(self, "batch_sizes",
                               tuple(int(b) for b in self.batch_sizes))
        if self.key_sample is not None:
            object.__setattr__(self, "key_sample",
                               tuple(float(k) for k in self.key_sample))
        object.__setattr__(self, "candidate_errors",
                           tuple(int(e) for e in self.candidate_errors))

    # ---------------------------------------------------------- serialization
    def to_json(self) -> str:
        """Serialize for config files; ``from_json`` restores an equal spec."""
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FitSpec":
        """Restore a spec from ``to_json`` output of either package (the
        reference's TPU profile, ``tpu_params``, is dropped)."""
        return cls._from_dict(json.loads(text))

    @classmethod
    def _from_dict(cls, d: dict) -> "FitSpec":
        d = dict(d)
        d.pop("tpu_params", None)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FitSpec fields in JSON: "
                            f"{sorted(unknown)}")
        for pname, pcls in (("cpu_params", CostParams),
                            ("gpu_params", GPUCostParams)):
            if d.get(pname) is not None:
                pknown = {f.name for f in dataclasses.fields(pcls)}
                punknown = set(d[pname]) - pknown
                if punknown:
                    raise ValueError(f"unknown FitSpec fields in JSON under "
                                     f"{pname}: {sorted(punknown)}")
                d[pname] = pcls(**d[pname])
        for name in ("batch_sizes", "key_sample", "candidate_errors"):
            if d.get(name) is not None:
                d[name] = tuple(d[name])
        return cls(**d)

    # ---------------------------------------------------------------- helpers
    @property
    def objective(self) -> str:
        if self.latency_budget_ns is not None:
            return "latency"
        if self.storage_budget_bytes is not None:
            return "space"
        return "error"


@dataclasses.dataclass(frozen=True)
class PlanCandidate:
    """One row of the planner's audit trail: a candidate error's prediction."""
    error: int
    n_segments: int
    latency_ns: float
    size_bytes: float
    feasible: bool     # meets the budget (always True for objective="error")
    chosen: bool


@dataclasses.dataclass(frozen=True)
class IndexPlan:
    """A fully resolved index configuration -- every knob the constructors
    need, plus the audit trail that justifies it.

    Produced by :func:`plan` (cost-model resolution of a :class:`FitSpec`)
    or :meth:`from_knobs` (trivial resolution of raw expert knobs, so the
    legacy constructors also carry a plan).  ``small_max``/``large_min`` are
    the dispatch tier thresholds; ``None`` means "let ``DispatchEngine``
    derive them from the cost model at build time" (the trivial-plan case).
    """

    error: int
    n_shards: int = 1
    buffer_size: int = 0
    backend: str = "cuda"
    small_max: int | None = None
    large_min: int | None = None
    publish_every: int | None = None
    # write mode: "inplace" is the paper's Alg. 4 per-tree delta buffer;
    # "lsm" routes writes through the tiered memtable -> learned-run ->
    # compaction plane (repro_torch.index.lsm), sized by the two
    # knobs below.
    write_mode: str = "inplace"
    memtable_capacity: int | None = None
    level_fanout: int | None = None
    # async-pipeline knobs (repro_torch.index.pipeline.AsyncIndexService):
    # fuse queued queries once flush_threshold of them are waiting (the planner
    # sets it to the large-tier dispatch crossing, so fused batches ride the
    # fast tier), flush a partial batch after max_wait_us, and bound the
    # request queue at queue_depth queries.  None = derive at pipeline build.
    flush_threshold: int | None = None
    max_wait_us: float | None = None
    queue_depth: int | None = None
    # device plane (index/device_plane.py's DeviceShardedService):
    # serve from a device-resident packed shard layout, one shard per
    # device.  exchange names the collective strategy for the search fan-out:
    # "allgather" (every device scores the full batch, psum-reduced),
    # "a2a" (owner-routed bucketed all_to_all with slack capacity), or
    # "auto" (per-call cost-model choice on the batch size).
    device_count: int | None = None
    exchange: str | None = None
    # provenance / audit trail
    objective: str = "raw"           # latency | space | error | raw
    budget: float | None = None
    hardware: str = "cpu"
    n_keys: int = 0                  # keys the plan was computed over
    candidates: tuple[PlanCandidate, ...] = ()
    spec: FitSpec | None = None
    # revision story: 0 = the plan open_index()/plan() produced; every
    # replace() (and every Replanner hot-swap) bumps it, so `svc.plan`
    # always names the currently-served revision and explain() diffs are
    # auditable instead of knobs mutating in place.
    revision: int = 0

    def __post_init__(self):
        if self.error < 1:
            raise ValueError(f"plan error must be >= 1, got {self.error}")
        if self.revision < 0:
            raise ValueError(f"revision must be >= 0, got {self.revision}")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if (self.small_max is None) != (self.large_min is None):
            raise ValueError("small_max and large_min must be set together "
                             "(or both None to defer to the cost model)")
        if self.write_mode not in ("inplace", "lsm"):
            raise ValueError(f"write_mode must be 'inplace' or 'lsm', got "
                             f"{self.write_mode!r}")
        if self.memtable_capacity is not None and self.memtable_capacity < 2:
            raise ValueError(f"memtable_capacity must be >= 2, got "
                             f"{self.memtable_capacity}")
        if self.level_fanout is not None and self.level_fanout < 2:
            raise ValueError(f"level_fanout must be >= 2, got "
                             f"{self.level_fanout}")
        if self.write_mode == "lsm" and self.n_shards != 1:
            raise ValueError("an lsm-mode plan is single-service (the level "
                             "structure absorbs write traffic instead of "
                             f"shard fan-out); got n_shards={self.n_shards}")
        if self.device_count is not None and self.device_count < 1:
            raise ValueError(f"device_count must be >= 1, got "
                             f"{self.device_count}")
        if self.exchange is not None \
                and self.exchange not in ("allgather", "a2a", "auto"):
            raise ValueError(f"exchange must be 'allgather', 'a2a' or 'auto'"
                             f" (or None), got {self.exchange!r}")
        if self.device_count is not None and self.write_mode == "lsm":
            raise ValueError("a device plan cannot use the lsm write mode: "
                             "the tiered write plane is host-resident")
        if self.flush_threshold is not None and self.flush_threshold < 1:
            raise ValueError(f"flush_threshold must be >= 1, got "
                             f"{self.flush_threshold}")
        if self.max_wait_us is not None and self.max_wait_us <= 0:
            raise ValueError(f"max_wait_us must be > 0, got "
                             f"{self.max_wait_us}")
        if self.queue_depth is not None and self.flush_threshold is not None \
                and self.queue_depth < self.flush_threshold:
            raise ValueError(f"queue_depth ({self.queue_depth}) must be >= "
                             f"flush_threshold ({self.flush_threshold})")

    @classmethod
    def from_knobs(cls, error: int, *, n_shards: int = 1, buffer_size: int = 0,
                   backend: str = "cuda",
                   publish_every: int | None = None,
                   write_mode: str = "inplace",
                   memtable_capacity: int | None = None,
                   level_fanout: int | None = None) -> "IndexPlan":
        """Trivial resolution: wrap raw expert knobs as a plan (no cost-model
        run; dispatch thresholds stay cost-model-derived at build time)."""
        return cls(error=int(error), n_shards=int(n_shards),
                   buffer_size=int(buffer_size), backend=backend,
                   publish_every=publish_every, write_mode=write_mode,
                   memtable_capacity=memtable_capacity,
                   level_fanout=level_fanout, objective="raw")

    # ---------------------------------------------------------- serialization
    def to_json(self) -> str:
        """Serialize for config files; ``from_json`` restores an equal plan."""
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "IndexPlan":
        """Restore a plan from ``to_json`` output, or from the reference's
        plan serialized the same way (``json.dumps(dataclasses.asdict(p))``):
        its backend names are mapped to the port's and its spec's TPU
        profile is dropped."""
        d = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown IndexPlan fields in JSON: "
                             f"{sorted(unknown)}")
        d["backend"] = _PORT_BACKENDS.get(d.get("backend"), d.get("backend"))
        d["candidates"] = tuple(PlanCandidate(**c)
                                for c in d.get("candidates", ()))
        if d.get("spec") is not None:
            d["spec"] = FitSpec._from_dict(d["spec"])
        return cls(**d)

    # --------------------------------------------------------------- revision
    def replace(self, **knobs) -> "IndexPlan":
        """A new frozen plan with ``knobs`` applied and ``revision`` bumped.

        The only sanctioned way to derive a changed configuration from a
        served plan: the original stays immutable, the successor carries
        ``revision + 1``, and ``explain()`` on both sides gives an auditable
        before/after.  ``revision`` itself cannot be passed."""
        if "revision" in knobs:
            raise ValueError("revision is managed by replace(); it always "
                             "becomes the source plan's revision + 1")
        unknown = set(knobs) - {f.name for f in dataclasses.fields(self)}
        if unknown:
            raise ValueError(f"unknown IndexPlan knobs: {sorted(unknown)}")
        return dataclasses.replace(self, revision=self.revision + 1, **knobs)

    # ------------------------------------------------------------ constructor
    def merge_engine_opts(self, engine_opts: dict[str, dict] | None
                          ) -> dict[str, dict] | None:
        """Fold the planned dispatch thresholds into ``engine_opts`` (caller-
        provided opts win; a trivial plan adds nothing)."""
        if self.small_max is None:
            return engine_opts
        opts = {k: dict(v) for k, v in (engine_opts or {}).items()}
        d = opts.setdefault("dispatch", {})
        d.setdefault("small_max", self.small_max)
        d.setdefault("large_min", self.large_min)
        return opts

    # ------------------------------------------------------------------ audit
    def explain(self) -> str:
        """Human-readable report: the chosen configuration and the predicted
        latency/size of every candidate error (chosen and rejected)."""
        head = f"IndexPlan: objective={self.objective}"
        if self.budget is not None:
            unit = "ns" if self.objective == "latency" else "B"
            head += f" (budget {self.budget:g} {unit})"
        head += f", hardware={self.hardware}, planned over {self.n_keys} keys"
        head += f", revision={self.revision}"
        lines = [
            head,
            f"  error={self.error}  n_shards={self.n_shards}  "
            f"buffer_size={self.buffer_size}  backend={self.backend}  "
            f"publish_every={self.publish_every}",
        ]
        if self.write_mode == "lsm":
            if self.spec is not None and self.spec.write_heavy:
                why = "spec declares write_heavy=True"
            elif self.spec is not None and self.spec.insert_rate > 0:
                why = (f"error={self.error} leaves no Alg. 4 insert buffer "
                       f"yet the spec promises insert_rate="
                       f"{self.spec.insert_rate:g}/s")
            else:
                why = "requested via raw knobs"
            lines.append(
                f"  write mode: lsm ({why}) -- memtable of "
                f"{self.memtable_capacity} keys spills into size-tiered "
                f"learned runs, compaction merges {self.level_fanout} runs "
                f"per level off the serving path")
        if self.small_max is not None:
            lines.append(
                f"  dispatch tiers (cost-model crossings): numpy <= "
                f"{self.small_max} < torch-bisect < {self.large_min} <= "
                f"cuda")
        if self.device_count is not None:
            line = (f"  device plane: {self.device_count} device(s), one "
                    f"shard each; exchange={self.exchange}")
            if self.exchange in ("allgather", "a2a") \
                    and self.device_count > 1:
                seg = next((c.n_segments for c in self.candidates
                            if c.chosen), None)
                if seg is None:  # raw plan: rough worst-case segmentation
                    seg = max(1, math.ceil(max(1, self.n_keys)
                                           / (2 * self.error)))
                per_dev = max(1, math.ceil(seg / self.device_count))
                gpu = (self.spec.gpu_params if self.spec is not None
                       else GPUCostParams())
                cross = exchange_crossover_batch(
                    self.device_count, self.error, per_dev, gpu)
                line += (" (a2a never wins under the model)" if cross is None
                         else f" (modeled a2a crossover ~{cross} "
                              f"queries/batch)")
            lines.append(line)
        if self.flush_threshold is not None:
            lines.append(
                f"  async pipeline: coalesce {self.flush_threshold} queued "
                f"queries into one fused batch (or flush after "
                f"{self.max_wait_us:g} us), queue bounded at "
                f"{self.queue_depth} queries")
        if self.spec is not None and self.spec.range_fraction > 0:
            lines.append(
                f"  scan-heavy workload: range_fraction="
                f"{self.spec.range_fraction:g} x ~{self.spec.range_scan_rows}"
                f" rows/scan folded into every candidate latency and the "
                f"dispatch crossings")
        if self.candidates:
            lines.append("  candidates (predicted by the Sec. 6 model):")
            lines.append("    error  segments  latency_ns    size_bytes")
            for c in self.candidates:
                mark = "chosen" if c.chosen else (
                    "" if c.feasible else "infeasible")
                lines.append(
                    f"    {c.error:>5d}  {c.n_segments:>8d}  "
                    f"{c.latency_ns:>10.1f}  {c.size_bytes:>12.0f}  {mark}")
        return "\n".join(lines)


def _resolve_keys(keys, spec: FitSpec, assume_sorted: bool) -> np.ndarray:
    if keys is not None:
        arr = np.asarray(keys, np.float64).ravel()
    elif spec.key_sample is not None:
        arr = np.asarray(spec.key_sample, np.float64)
    else:
        raise ValueError("plan() needs keys (or a FitSpec.key_sample to plan "
                         "from a representative sample)")
    if arr.shape[0] == 0:
        raise ValueError("cannot plan over an empty key set")
    return arr if assume_sorted else np.sort(arr, kind="stable")


def _plan_shards(spec: FitSpec, n_keys: int) -> int:
    """Shard-count heuristic: enough shards that (a) each holds at most
    ~_SHARD_TARGET_KEYS (bounds per-shard publish cost) and (b) each absorbs
    at most ~_SHARD_TARGET_INSERTS_PER_S of the expected write traffic
    (independent epoch streams keep a write-hot range from blocking reads on
    the rest); capped by the duplicate-safe cut requirement (>= 1 distinct
    run per shard) and _MAX_PLANNED_SHARDS."""
    total = max(n_keys, spec.n_keys_hint or 0)
    size_shards = math.ceil(total / _SHARD_TARGET_KEYS)
    write_shards = (math.ceil(spec.insert_rate / _SHARD_TARGET_INSERTS_PER_S)
                    if spec.insert_rate > 0 else 1)
    n = max(1, size_shards, write_shards)
    distinct = max(1, int(total * (1.0 - spec.duplicate_density)))
    return min(n, distinct, _MAX_PLANNED_SHARDS)


def planned_buffer(error: int) -> int:
    """Per-segment Alg. 4 insert buffer the planner pairs with ``error``: a
    quarter of the error budget (err_seg = error - buffer keeps the
    user-visible bound, Sec. 5).  Every planned service is writable when the
    budget allows it; error=1 leaves no room."""
    if error < 2:
        return 0
    return min(max(2, error // 4), error - 1)


def _plan_buffer(spec: FitSpec, error: int) -> int:
    """The chosen error's buffer, with the write-traffic conflict made loud
    (an error=1 plan cannot honor a promised insert rate).  Only reachable
    when the spec pins ``write_heavy=False``; the default tri-state resolves
    this case to the LSM write mode instead (:func:`_plan_write_mode`)."""
    buffer = planned_buffer(error)
    if buffer == 0 and spec.insert_rate > 0:
        raise ValueError(
            "the resolved error=1 leaves no room for an Alg. 4 insert "
            "buffer (buffer_size < error, Sec. 5), but the spec promises "
            f"insert_rate={spec.insert_rate:g}/s; relax the budget so a "
            "larger error is chosen, drop the insert_rate hint for a "
            "read-only index, or lift write_heavy=False so the planner can "
            "fall back to the LSM write mode")
    return buffer


# LSM sizing: spill roughly every _LSM_SPILL_PERIOD_S of expected ingest so
# runs stay re-fit-sized, clamped to keep memtable writes O(small memmove).
_LSM_SPILL_PERIOD_S = 0.25
_LSM_MEMTABLE_MIN = 1024
_LSM_MEMTABLE_MAX = 65_536
_LSM_DEFAULT_FANOUT = 4


def _plan_write_mode(spec: FitSpec, error: int) -> str:
    """Resolve the tri-state ``write_heavy`` hint: explicit wins; unset
    falls back to LSM exactly when the in-place path would be a planning
    error (no Alg. 4 buffer fits yet inserts are promised)."""
    if spec.write_heavy is False:
        return "inplace"
    if spec.write_heavy:
        return "lsm"
    if spec.insert_rate > 0 and planned_buffer(error) == 0:
        return "lsm"
    return "inplace"


def _plan_memtable(spec: FitSpec) -> int:
    """Memtable capacity from the promised ingest: ~one spill per
    ``_LSM_SPILL_PERIOD_S`` at ``insert_rate``, clamped."""
    if spec.insert_rate <= 0:
        return _LSM_MEMTABLE_MIN * 4
    cap = int(spec.insert_rate * _LSM_SPILL_PERIOD_S)
    return min(max(cap, _LSM_MEMTABLE_MIN), _LSM_MEMTABLE_MAX)


def _effective_scorers(spec: FitSpec, segments_fn):
    """Per-candidate ``(eff_segments, eff_latency)`` scoring the
    configuration :func:`plan` would actually *build*, not the bare error:
    the insert buffer is carved out of the error budget (Sec. 5), so the
    tree segments -- and the served snapshot routes and window-searches --
    at ``err_seg = error - planned_buffer(error)`` (more segments, smaller
    windows than the bare error), and the paper's buffer-scan term uses the
    planned buffer.  Snapshot serving never scans write-side buffers during
    lookups (they are invisible until publish), so that term is pure
    pessimism: a budget met under this scoring is met by the built index.

    A ``range_fraction`` workload blends the range-scan cost term in: that
    fraction of queries pays the range model (predecessor locate + per-row
    scan over ``range_scan_rows`` rows) instead of the point model, so a
    scan-heavy spec is scored -- and budgeted -- on the workload it will
    actually serve."""
    rf, rows = spec.range_fraction, spec.range_scan_rows

    def eff_error(e: int) -> int:
        return max(1, e - planned_buffer(e))

    def eff_segments(e: int) -> int:
        return segments_fn(eff_error(e))

    if spec.hardware == "gpu":
        def eff_latency(e: int, s: int) -> float:
            point = latency_ns_gpu(eff_error(e), s, spec.gpu_params)
            if rf == 0.0:
                return point
            rng = range_latency_ns_gpu(eff_error(e), s, spec.gpu_params, rows)
            return (1.0 - rf) * point + rf * rng
    else:
        def eff_latency(e: int, s: int) -> float:
            p = dataclasses.replace(spec.cpu_params,
                                    buffer_size=planned_buffer(e))
            point = latency_ns(eff_error(e), s, p)
            if rf == 0.0:
                return point
            rng = range_latency_ns(eff_error(e), s, p, rows)
            return (1.0 - rf) * point + rf * rng

    return eff_segments, eff_latency


def _scan_term_ns(spec: FitSpec) -> float:
    """The workload's amortized range-scan contribution to per-query latency
    (the error-independent part: fraction x rows x per-row marginal)."""
    per_row = (scan_ns_per_row_gpu(spec.gpu_params)
               if spec.hardware == "gpu" else
               spec.cpu_params.scan_ns_per_row)
    return spec.range_fraction * spec.range_scan_rows * per_row


def _plan_backend(spec: FitSpec, small_max: int, large_min: int) -> str:
    """Default backend from the expected batch-size distribution: a workload
    living entirely inside one tier skips the dispatch layer."""
    if not spec.batch_sizes:
        return "dispatch"
    lo, hi = min(spec.batch_sizes), max(spec.batch_sizes)
    if hi <= small_max:
        return "numpy"
    if lo >= large_min:
        return "cuda"
    if lo > small_max and hi < large_min:
        return "torch-bisect"
    return "dispatch"


def plan(keys, spec: FitSpec, *, assume_sorted: bool = False) -> IndexPlan:
    """Resolve a :class:`FitSpec` against ``keys`` (or the spec's own
    ``key_sample``) into a concrete :class:`IndexPlan`.

    Pure planning: learns the error->segments curve for this data
    (:func:`learn_segments_fn`), scores every candidate error under the
    spec's hardware latency model, picks the error via the paper's Sec. 6
    choosers (smallest size meeting a latency budget / fastest within a
    space budget / pinned), then derives the shard count, insert buffer,
    default backend, auto-publish cadence, and the cost-model-calibrated
    dispatch tier thresholds.  Raises :class:`InfeasibleSpecError` (naming
    the tightest achievable budget) when no candidate fits.
    ``assume_sorted=True`` skips the sort-copy of ``keys`` (results are
    garbage if they are not actually sorted).
    """
    arr = _resolve_keys(keys, spec, assume_sorted)
    cands = tuple(sorted(set(int(e) for e in spec.candidate_errors)))
    if spec.error is not None and spec.error not in cands:
        cands = tuple(sorted((*cands, int(spec.error))))
    segments_fn = learn_segments_fn(arr, cands, sample=spec.segment_sample)
    eff_segments, eff_latency = _effective_scorers(spec, segments_fn)
    p = spec.cpu_params

    rows = [(e, eff_segments(e)) for e in cands]
    lats = {e: eff_latency(e, s) for e, s in rows}
    sizes = {e: size_bytes(e, s, p) for e, s in rows}

    budget: float | None = None
    if spec.objective == "latency":
        budget = float(spec.latency_budget_ns)
        chosen = choose_error_for_latency(budget, eff_segments, cands, p,
                                          latency_fn=eff_latency)
        if chosen is None:
            tightest = min(lats.values())
            note = ""
            scan = _scan_term_ns(spec)
            if scan >= tightest / 2:
                # the budget is lost to scanning, not to locating: say so
                note = (f"; note the range-scan term alone contributes "
                        f"{scan:g} ns of that (range_fraction="
                        f"{spec.range_fraction:g} x range_scan_rows="
                        f"{spec.range_scan_rows} rows), which no error "
                        f"parameter can reduce -- lower the scan "
                        f"selectivity hints or budget for the scans")
            raise InfeasibleSpecError("latency", budget, tightest, "ns",
                                      note=note)
        feasible = {e: lats[e] <= budget for e, _ in rows}
    elif spec.objective == "space":
        budget = float(spec.storage_budget_bytes)
        chosen = choose_error_for_space(budget, eff_segments, cands, p,
                                        latency_fn=eff_latency)
        if chosen is None:
            raise InfeasibleSpecError("space", budget, min(sizes.values()),
                                      "bytes")
        feasible = {e: sizes[e] <= budget for e, _ in rows}
    else:
        chosen = int(spec.error)
        feasible = {e: True for e, _ in rows}

    write_mode = _plan_write_mode(spec, chosen)
    if write_mode == "lsm":
        # no Alg. 4 buffer exists on the tiered path: the memtable is the
        # write absorber and compaction the re-fit cadence
        buffer_size = 0
        memtable_capacity = _plan_memtable(spec)
        level_fanout = _LSM_DEFAULT_FANOUT
    else:
        buffer_size = _plan_buffer(spec, chosen)
        memtable_capacity = None
        level_fanout = None
    n_segments = eff_segments(chosen)
    # thresholds for the table the engine will actually see: a published
    # snapshot carries err_seg as its error (tree.as_table), and
    # DispatchEngine derives from table.error/n_segments
    small_max, large_min = dispatch_thresholds(
        max(1, chosen - buffer_size), n_segments,
        spec.cpu_params, spec.gpu_params,
        range_fraction=spec.range_fraction, scan_rows=spec.range_scan_rows)
    # LSM plans stay single-service: the level structure absorbs the write
    # traffic the shard heuristic would otherwise fan out over epochs
    n_shards = 1 if write_mode == "lsm" else _plan_shards(spec, arr.shape[0])
    backend = _plan_backend(spec, small_max, large_min)
    device_count = None
    exchange = None
    if spec.device_count is not None:
        if write_mode == "lsm":
            raise ValueError(
                "the spec resolved to the lsm write mode (insert_rate="
                f"{spec.insert_rate:g}/s with no Alg. 4 buffer at error="
                f"{chosen}) but also asks for device_count="
                f"{spec.device_count}; the tiered write plane is "
                "host-resident -- relax the budget so a buffered error is "
                "chosen, or drop one of the two hints")
        # one shard per device, still capped by the duplicate-safe cut
        # requirement (each device needs at least one distinct key run)
        total = max(arr.shape[0], spec.n_keys_hint or 0)
        distinct = max(1, int(total * (1.0 - spec.duplicate_density)))
        device_count = min(int(spec.device_count), distinct)
        n_shards = device_count
        backend = "device"
        # score the collective exchange at the largest expected batch (the
        # a2a crossover favors big batches: routed work is ~slack*Q/D per
        # device vs the full Q under allgather)
        rep_batch = max(spec.batch_sizes) if spec.batch_sizes else 4096
        exchange = choose_exchange(rep_batch, device_count,
                                   max(1, chosen - buffer_size), n_segments,
                                   spec.gpu_params)
    # auto-publish roughly once per second of expected write traffic, kept
    # inside sane bounds; read-only workloads publish manually (the lsm
    # cadence drives spill/compaction maintenance through the same knob)
    publish_every = None
    if spec.insert_rate > 0 and (buffer_size > 0 or write_mode == "lsm"):
        publish_every = int(min(max(spec.insert_rate, 64), 65_536))
    # async-pipeline knobs: fuse once a flush earns the large (fused) tier,
    # bound the wait for a partial batch, and give the queue a few flushes of
    # headroom (see repro_torch.index.pipeline for the serving semantics)
    from .pipeline import DEFAULT_MAX_WAIT_US, DEFAULT_QUEUE_DEPTH_FLUSHES
    flush_threshold = int(large_min)
    max_wait_us = DEFAULT_MAX_WAIT_US
    queue_depth = DEFAULT_QUEUE_DEPTH_FLUSHES * flush_threshold

    candidates = tuple(
        PlanCandidate(error=e, n_segments=s, latency_ns=lats[e],
                      size_bytes=sizes[e], feasible=feasible[e],
                      chosen=(e == chosen))
        for e, s in rows)
    return IndexPlan(error=chosen, n_shards=n_shards,
                     buffer_size=buffer_size, backend=backend,
                     small_max=small_max, large_min=large_min,
                     publish_every=publish_every, write_mode=write_mode,
                     memtable_capacity=memtable_capacity,
                     level_fanout=level_fanout,
                     flush_threshold=flush_threshold,
                     max_wait_us=max_wait_us, queue_depth=queue_depth,
                     device_count=device_count, exchange=exchange,
                     objective=spec.objective,
                     budget=budget, hardware=spec.hardware,
                     n_keys=int(arr.shape[0]), candidates=candidates,
                     spec=spec)


def open_index(keys, spec_or_plan: "FitSpec | IndexPlan", *,
               payload: np.ndarray | None = None, **service_kwargs):
    """The single SLO-driven entry point: plan (if needed) and build.

    Returns a ``DeviceShardedService`` for a ``backend="device"`` plan, an
    ``LsmIndexService`` for a ``write_mode="lsm"`` plan, an ``IndexService``
    for a one-shard plan, else a ``ShardedIndexService`` -- all ready for
    the full insert -> publish -> lookup cycle with no raw knob supplied by
    the caller, serving on the backend the plan chose (on the CUDA card for
    the device backends; a device plan's rows on ``cuda:0 .. D-1``, raising
    where fewer cards exist, unless ``devices=[...]`` names them).  Extra
    ``service_kwargs`` (e.g. ``skew_threshold``, ``auto_rebalance``,
    ``mode``, ``devices``) pass through to the service constructor.
    """
    if keys is None:
        raise ValueError("open_index needs the real key array; plan(None, "
                         "spec) is the offline half that works from a "
                         "FitSpec.key_sample")
    if not service_kwargs.get("assume_sorted", False):
        # sort exactly once here: plan() needs sorted keys and the service
        # would otherwise re-sort the same array at construction
        keys = np.asarray(keys, np.float64).ravel()
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        if payload is not None:
            payload = np.asarray(payload)[order]
        service_kwargs["assume_sorted"] = True
    resolved = (plan(keys, spec_or_plan, assume_sorted=True)
                if isinstance(spec_or_plan, FitSpec) else spec_or_plan)
    if not isinstance(resolved, IndexPlan):
        raise TypeError(f"open_index needs a FitSpec or IndexPlan, got "
                        f"{type(spec_or_plan).__name__}")
    # lazy: the services import this module for their plan= constructors
    if resolved.backend == "device":
        from .device_plane import DeviceShardedService
        return DeviceShardedService.from_plan(keys, resolved, payload=payload,
                                              **service_kwargs)
    if resolved.write_mode == "lsm":
        from .lsm import LsmIndexService
        return LsmIndexService.from_plan(keys, resolved, payload=payload,
                                         **service_kwargs)
    if resolved.n_shards > 1:
        from .sharded import ShardedIndexService
        return ShardedIndexService.from_plan(keys, resolved, payload=payload,
                                             **service_kwargs)
    from repro_torch.serve.index_service import IndexService
    return IndexService.from_plan(keys, resolved, payload=payload,
                                  **service_kwargs)


def brute_force_choice(keys, spec: FitSpec) -> int:
    """Reference oracle for tests: exhaustively score every candidate with
    the same models and apply the Sec. 6 selection rule directly (no chooser
    functions, no interpolation shortcuts beyond the shared segments_fn)."""
    arr = _resolve_keys(keys, spec, assume_sorted=False)
    cands = tuple(sorted(set(int(e) for e in spec.candidate_errors)))
    segments_fn = learn_segments_fn(arr, cands, sample=spec.segment_sample)
    eff_segments, eff_latency = _effective_scorers(spec, segments_fn)
    scored = [(e, eff_latency(e, eff_segments(e)),
               size_bytes(e, eff_segments(e), spec.cpu_params))
              for e in cands]
    if spec.objective == "latency":
        ok = [(sz, e) for e, lat, sz in scored
              if lat <= spec.latency_budget_ns]
        if not ok:
            raise InfeasibleSpecError("latency", spec.latency_budget_ns,
                                      min(lat for _, lat, _ in scored), "ns")
        return min(ok)[1]
    if spec.objective == "space":
        ok = [(lat, e) for e, lat, sz in scored
              if sz <= spec.storage_budget_bytes]
        if not ok:
            raise InfeasibleSpecError("space", spec.storage_budget_bytes,
                                      min(sz for _, _, sz in scored), "bytes")
        return min(ok)[1]
    return int(spec.error)
