"""Backend registry and the active-execution context.

  register(backend)                     — add an engine
  get_backend("cuda")                   — look one up
  with use("cuda", policy=pol): ...     — scoped default (contextvar-based)
  set_default("popcount")               — process-wide default
  resolve(op, backend=..., policy=...)  — what dispatch calls

Backend: explicit ``backend=`` > ``use()`` context > ``set_default`` >
``cuda``, the kernel engine. Policy: explicit ``policy=`` > ``use()`` >
``set_default`` > DEFAULT_POLICY.

Fallback, as in the reference: if the context or default engine cannot
run an op (probed via ``Backend.supports``), the first *registered* engine
that can is used (torch_dot, popcount, cuda, in that order), with a
RuntimeWarning once per (engine, op, fallback) triple. An *explicitly*
requested engine never falls back: it raises, so tests pin engines. The
fallback is by capability only; a kernel that fails to build or launch
raises, whatever engine was asked for.
"""
from __future__ import annotations

import contextvars
import warnings

from repro_torch.api.backend import Backend, UnsupportedOpError
from repro_torch.api.policy import DEFAULT_POLICY, ExecutionPolicy

__all__ = ["register", "get_backend", "list_backends", "use", "set_default",
           "current", "resolve", "DEFAULT_BACKEND"]

DEFAULT_BACKEND = "cuda"

_REGISTRY: dict[str, Backend] = {}
_ORDER: list[str] = []  # registration order = fallback priority

# Process-wide default (mutable via set_default); the contextvar holds
# scoped overrides as (backend_name | None, policy | None).
_default: tuple[str, ExecutionPolicy] = (DEFAULT_BACKEND, DEFAULT_POLICY)
_active: contextvars.ContextVar[tuple[str | None, ExecutionPolicy | None] | None] = \
    contextvars.ContextVar("repro_torch_api_active", default=None)
_warned_fallbacks: set = set()


def register(backend: Backend, *, override: bool = False) -> Backend:
    if not backend.name or backend.name == "abstract":
        raise ValueError("backend must define a non-default .name")
    if backend.name in _REGISTRY and not override:
        raise ValueError(f"backend {backend.name!r} already registered "
                         "(pass override=True to replace)")
    if backend.name not in _ORDER:
        _ORDER.append(backend.name)
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str | Backend) -> Backend:
    if isinstance(name, Backend):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def list_backends() -> tuple[str, ...]:
    return tuple(_ORDER)


def set_default(backend: str | Backend | None = None,
                policy: ExecutionPolicy | None = None) -> None:
    """Set the process-wide default backend and/or policy."""
    global _default
    name = get_backend(backend).name if backend is not None else _default[0]
    pol = policy if policy is not None else _default[1]
    _default = (name, pol)


class use:
    """Scoped backend/policy default: ``with repro_torch.api.use("cuda", policy=p):``.

    Either argument may be omitted to inherit the surrounding context.
    Re-entrant and safe across threads/async tasks (contextvars).
    """

    def __init__(self, backend: str | Backend | None = None,
                 policy: ExecutionPolicy | None = None):
        self._name = get_backend(backend).name if backend is not None else None
        self._policy = policy
        self._token = None

    def __enter__(self):
        outer = _active.get() or (None, None)
        name = self._name if self._name is not None else outer[0]
        pol = self._policy if self._policy is not None else outer[1]
        self._token = _active.set((name, pol))
        return self

    def __exit__(self, *exc):
        _active.reset(self._token)
        return False


def current() -> tuple[Backend, ExecutionPolicy]:
    """The (backend, policy) pair dispatch would use right now."""
    ctx = _active.get() or (None, None)
    name = ctx[0] if ctx[0] is not None else _default[0]
    pol = ctx[1] if ctx[1] is not None else _default[1]
    return get_backend(name), pol


def resolve(op: str, *, backend: str | Backend | None = None,
            policy: ExecutionPolicy | None = None,
            s: int = 1, t: int = 1) -> tuple[Backend, ExecutionPolicy]:
    """Pick the backend and policy for one op call.

    Explicit ``backend=`` pins the engine (raises if it cannot run the
    op); otherwise the context or default engine is used, falling back
    across the registry in registration order when it lacks the
    capability. Raises when no engine can run the op.
    """
    cur_be, cur_pol = current()
    pol = policy if policy is not None else cur_pol
    if backend is not None:
        be = get_backend(backend)
        if not be.supports(op, s=s, t=t):
            raise UnsupportedOpError(
                f"backend {be.name!r} does not support {op} with s={s}, t={t} "
                f"(capabilities: {sorted(be.capabilities)}, bits "
                f"{be.min_bits}..{be.max_bits})")
        return be, pol
    if cur_be.supports(op, s=s, t=t):
        return cur_be, pol
    for name in _ORDER:
        cand = _REGISTRY[name]
        if cand.supports(op, s=s, t=t):
            key = (cur_be.name, op, name)
            if key not in _warned_fallbacks:
                _warned_fallbacks.add(key)
                warnings.warn(
                    f"backend {cur_be.name!r} does not support {op} with "
                    f"s={s}, t={t}; falling back to {name!r}", RuntimeWarning,
                    stacklevel=3)
            return cand, pol
    raise UnsupportedOpError(
        f"no registered backend supports {op} with s={s}, t={t} "
        f"(registered: {sorted(_REGISTRY)})")
