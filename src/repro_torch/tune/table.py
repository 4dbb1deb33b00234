"""Persisted, versioned tuning table: measured ExecutionPolicy per cell.

The reference's ``repro.tune.table`` for the port. A `TuningTable` maps
``(op, bits, sparsity_band, shape_bucket)`` to the `ExecutionPolicy` that
won a sweep. It is a JSON artifact with an explicit ``schema_version`` and
provenance metadata (host, torch and CUDA versions, the device, backend
capabilities) so trajectories are never silently compared across machines
or incompatible formats.

Lookup is nearest-bucket, not exact-match: a query resolves to the
closest swept cell under a log-scale distance (sparsity band weighted
heaviest: it decides jump mode; then bits, then shape). The table is
ADVISORY: every backend/policy pair returns bit-identical int32 results,
so a wrong nearest match costs performance, never answers.

Which table is active (consulted by ``api.resolve`` and
``serve.GNNServer``), in precedence
order:

  with use_table(t): ...        — contextvar-scoped (threads/async safe)
  install(t)                    — process-wide; install(None) disables,
                                  install() restores AUTO
  the packaged default artifact — src/repro_torch/tune/tables/
                                  h100_kernels.json, written only by a
                                  sweep run on an H100

``tables/h100_kernels.json`` is that artifact, written by
``repro_torch.launch.sweep`` on an H100 from ``sweeps/h100.json``, so
``api.resolve`` and ``GNNServer(tuning_table="auto")`` consult it by
default. A corrupt,
stale (schema-mismatched) or missing table file, or one holding a policy
the port's ``ExecutionPolicy`` rejects (the reference's CPU table tiles
16 x 128, past the port's 1024 threads), warns once and resolves to "no
table": dispatch NEVER crashes because tuning data rotted.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import math
import pathlib
import warnings

from repro_torch.api.policy import ExecutionPolicy

__all__ = [
    "AUTO", "SCHEMA_VERSION", "DEFAULT_TABLE_PATH",
    "TableEntry", "TuningTable",
    "policy_to_dict", "policy_from_dict", "provenance",
    "active_table", "default_table", "dispatch_policy", "install",
    "use_table",
]

SCHEMA_VERSION = 1
DEFAULT_TABLE_PATH = (pathlib.Path(__file__).resolve().parent
                      / "tables" / "h100_kernels.json")

# dispatch-layer op names vs the historical BENCH_kernels.json spellings
_OP_ALIASES = {"bitserial_gemm": "bitserial_mm"}

_POLICY_FIELDS = tuple(f.name for f in dataclasses.fields(ExecutionPolicy))

_warned: set = set()


def _warn_once(msg: str) -> None:
    if msg not in _warned:
        _warned.add(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _norm_op(op: str) -> str:
    return _OP_ALIASES.get(op, op)


# ------------------------------------------------------ policy (de)serialize

def policy_to_dict(pol: ExecutionPolicy) -> dict:
    """Full field dict (JSON-safe) — explicit beats diff-against-default."""
    return {k: getattr(pol, k) for k in _POLICY_FIELDS}


def policy_from_dict(d: dict) -> ExecutionPolicy:
    """Inverse of `policy_to_dict`; construction-time validation applies."""
    if not isinstance(d, dict):
        raise ValueError(f"policy must be a dict, got {type(d).__name__}")
    unknown = set(d) - set(_POLICY_FIELDS)
    if unknown:
        raise ValueError(f"unknown ExecutionPolicy fields {sorted(unknown)} "
                         f"(known: {list(_POLICY_FIELDS)})")
    return ExecutionPolicy(**d)


def _card_line() -> str | None:
    """``name, power.limit`` of the first card as nvidia-smi prints them
    (a card may be capped below its maximum and then runs slower), or None
    when nvidia-smi cannot say."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def provenance(extra: dict | None = None) -> dict:
    """Host/toolchain/backend metadata stamped into tables and records.

    Best-effort: a table must stay loadable on a host without a card, so
    probe failures degrade to absent keys, never exceptions.
    """
    import platform

    import torch

    meta = {
        "host": platform.node(),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    try:
        if torch.cuda.is_available():
            meta["device"] = torch.cuda.get_device_name(0)
            meta["card"] = _card_line()
    except RuntimeError:  # pragma: no cover - CUDA present but unusable
        pass
    from repro_torch import api
    meta["backends"] = {name: sorted(api.get_backend(name).capabilities)
                        for name in api.list_backends()}
    if extra:
        meta.update(extra)
    return meta


# ------------------------------------------------------------------- entries

@dataclasses.dataclass(frozen=True)
class TableEntry:
    """One swept cell: the winning policy plus how it was measured."""
    op: str
    bits: int
    sparsity_band: float
    shape_bucket: tuple            # (m, k, n) — serve: (n_pad, n_pad, d_in)
    policy: ExecutionPolicy
    backend: str | None = None     # backend the winner was measured on
    median_ms: float | None = None
    baseline_ms: float | None = None  # DEFAULT_POLICY arm on the same cell

    @property
    def key(self) -> tuple:
        return (_norm_op(self.op), self.bits, self.sparsity_band,
                self.shape_bucket)

    def to_dict(self) -> dict:
        return {
            "op": self.op, "bits": self.bits,
            "sparsity_band": self.sparsity_band,
            "shape_bucket": list(self.shape_bucket),
            "policy": policy_to_dict(self.policy),
            "backend": self.backend,
            "median_ms": self.median_ms,
            "baseline_ms": self.baseline_ms,
        }

    @staticmethod
    def from_dict(d: dict) -> "TableEntry":
        required = ("op", "bits", "sparsity_band", "shape_bucket", "policy")
        missing = [k for k in required if k not in d]
        if missing:
            raise ValueError(f"table entry missing {missing}: {d}")
        bits = d["bits"]
        if not isinstance(bits, int) or bits <= 0:
            raise ValueError(f"entry bits must be a positive int, got {bits!r}")
        band = float(d["sparsity_band"])
        if not 0.0 <= band <= 1.0:
            raise ValueError(f"entry sparsity_band must be in [0, 1], "
                             f"got {band}")
        shape = tuple(d["shape_bucket"])
        if len(shape) != 3 or any(not isinstance(x, int) or x <= 0
                                  for x in shape):
            raise ValueError(f"entry shape_bucket must be 3 positive ints, "
                             f"got {d['shape_bucket']!r}")
        return TableEntry(
            op=str(d["op"]), bits=bits, sparsity_band=band,
            shape_bucket=shape, policy=policy_from_dict(d["policy"]),
            backend=d.get("backend"), median_ms=d.get("median_ms"),
            baseline_ms=d.get("baseline_ms"))


def _distance(e: TableEntry, bits, sparsity, shape) -> float:
    """Log-scale nearest-bucket distance; sparsity band dominates.

    A 0.9 band gap scores 3.6 — more than a 16x shape mismatch (1.0) or a
    3-octave bits gap (3.0): the band decides jump mode, the costliest
    knob to get wrong. A query with unknown sparsity counts as dense
    (0.0) — the conservative band, where jumping never pays.
    """
    d = 0.0
    if bits is not None:
        d += abs(math.log2(max(int(bits), 1)) - math.log2(max(e.bits, 1)))
    q_sp = 0.0 if sparsity is None else float(sparsity)
    d += 4.0 * abs(q_sp - e.sparsity_band)
    if shape is not None:
        for q, s in zip(shape, e.shape_bucket):
            d += abs(math.log2(max(int(q), 1))
                     - math.log2(max(int(s), 1))) / 4.0
    return d


# --------------------------------------------------------------------- table

class TuningTable:
    """Versioned (op, bits, sparsity_band, shape_bucket) -> policy map."""

    def __init__(self, entries=(), meta: dict | None = None):
        self.entries: list[TableEntry] = []
        self.meta: dict = dict(meta or {})
        self._memo: dict = {}
        for e in entries:
            self.put(e)

    def __len__(self) -> int:
        return len(self.entries)

    def __repr__(self) -> str:
        ops = sorted({_norm_op(e.op) for e in self.entries})
        return f"TuningTable({len(self.entries)} entries, ops={ops})"

    def put(self, entry: TableEntry) -> None:
        """Insert, replacing any entry with the same cell key."""
        self.entries = [e for e in self.entries if e.key != entry.key]
        self.entries.append(entry)
        self._memo.clear()

    def lookup(self, op: str, *, bits: int | None = None,
               sparsity: float | None = None,
               shape: tuple | None = None) -> TableEntry | None:
        """Nearest swept cell for the query, or None if the op is unknown.

        Ties break on file order (deterministic for a committed artifact).
        Results are memoized — dispatch calls this per GEMM.
        """
        key = (_norm_op(op), bits, sparsity, shape)
        if key in self._memo:
            return self._memo[key]
        cands = [e for e in self.entries if _norm_op(e.op) == key[0]]
        best = None
        if cands:
            best = min(
                enumerate(cands),
                key=lambda ie: (_distance(ie[1], bits, sparsity, shape),
                                ie[0]))[1]
        self._memo[key] = best
        return best

    def policy_for(self, op: str, *, bits=None, sparsity=None,
                   shape=None) -> ExecutionPolicy | None:
        e = self.lookup(op, bits=bits, sparsity=sparsity, shape=shape)
        return e.policy if e is not None else None

    # ------------------------------------------------------------ serialize

    def to_dict(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "meta": self.meta,
            "entries": [e.to_dict() for e in self.entries],
        }

    @staticmethod
    def from_dict(d: dict) -> "TuningTable":
        if not isinstance(d, dict):
            raise ValueError(f"tuning table must be a JSON object, "
                             f"got {type(d).__name__}")
        if "schema_version" not in d:
            raise ValueError("tuning table missing schema_version")
        if d["schema_version"] != SCHEMA_VERSION:
            raise ValueError(
                f"stale tuning-table schema_version {d['schema_version']!r} "
                f"(this build reads {SCHEMA_VERSION}); regenerate it with "
                f"a sweep")
        entries = d.get("entries")
        if not isinstance(entries, list):
            raise ValueError("tuning table entries must be a list")
        return TuningTable([TableEntry.from_dict(e) for e in entries],
                           meta=d.get("meta") or {})

    def save(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=1,
                                   sort_keys=True) + "\n")
        return path

    @staticmethod
    def load(path, *, strict: bool = False) -> "TuningTable | None":
        """Read a table file; corrupt/stale/missing warns and returns None.

        ``strict=True`` raises instead, for a validator that must fail on
        a malformed table rather than degrade to defaults.
        """
        path = pathlib.Path(path)
        try:
            raw = json.loads(path.read_text())
            return TuningTable.from_dict(raw)
        except FileNotFoundError:
            msg = (f"tuning table {path} not found; "
                   f"falling back to default policies")
        except (OSError, json.JSONDecodeError, KeyError, TypeError,
                ValueError) as e:
            msg = (f"tuning table {path} unusable ({e}); "
                   f"falling back to default policies")
        if strict:
            raise ValueError(msg)
        _warn_once(msg)
        return None


# ------------------------------------------------------- active-table state

class _Auto:
    __slots__ = ()

    def __repr__(self):  # pragma: no cover - repr cosmetics
        return "repro_torch.tune.AUTO"


#: Sentinel: "resolve to the packaged default artifact".
AUTO = _Auto()

_installed: "TuningTable | None | _Auto" = AUTO
_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_tune_active", default=AUTO)
_default_cache: "TuningTable | None | _Auto" = AUTO  # AUTO = not loaded yet


def _coerce(table):
    """Accept AUTO | None | TuningTable | path; paths degrade to None."""
    if table is AUTO or table is None or isinstance(table, TuningTable):
        return table
    return TuningTable.load(table)


def default_table() -> TuningTable | None:
    """The packaged artifact (written by a sweep on an H100), if any.

    A missing artifact resolves to None silently (a checkout may strip
    it); a CORRUPT artifact warns once.
    """
    global _default_cache
    if _default_cache is AUTO:
        _default_cache = (TuningTable.load(DEFAULT_TABLE_PATH)
                          if DEFAULT_TABLE_PATH.exists() else None)
    return _default_cache


def install(table=AUTO) -> None:
    """Process-wide active table: TuningTable, path, None (disable tuning),
    or AUTO (default: the packaged artifact)."""
    global _installed
    _installed = _coerce(table)


@contextlib.contextmanager
def use_table(table):
    """Scoped active table: ``with use_table(t): ...`` (contextvar-based).

    ``use_table(None)`` disables table consultation inside the block —
    dispatch falls straight through to DEFAULT_POLICY.
    """
    token = _ctx.set(_coerce(table))
    try:
        yield
    finally:
        _ctx.reset(token)


def active_table() -> TuningTable | None:
    """use_table context > install()ed table > packaged default artifact."""
    t = _ctx.get()
    if t is AUTO:
        t = _installed
    if t is AUTO:
        t = default_table()
    return t


def dispatch_policy(op: str, *, bits: int | None = None,
                    shape: tuple | None = None,
                    sparsity: float | None = None) -> ExecutionPolicy | None:
    """Table-backed policy for one dispatch call; None = no opinion.

    The hook a dispatcher calls when NO policy was given anywhere. It
    must never raise — tuning data rotting is a performance
    problem, not a correctness one — so any failure warns once and
    returns None (-> DEFAULT_POLICY downstream).
    """
    try:
        table = active_table()
        if table is None:
            return None
        return table.policy_for(op, bits=bits, sparsity=sparsity,
                                shape=shape)
    except Exception as e:  # defensive: dispatch must survive bad tables
        _warn_once(f"tuning-table lookup failed ({e}); "
                   f"using default policies")
        return None
