"""Backend registry and the active-execution context.

  register(backend)                     — add an engine
  get_backend("cuda")                   — look one up
  with use("cuda", policy=pol): ...     — scoped default (contextvar-based)
  set_default("popcount")               — process-wide default
  resolve(op, backend=..., policy=...)  — what dispatch calls

Backend: explicit ``backend=`` > ``use()`` context > ``set_default`` >
``cuda``, the kernel engine. Policy: explicit ``policy=`` > ``use()`` >
``set_default`` > DEFAULT_POLICY. Unlike the reference, an engine that
cannot run the op is never replaced by another one: ``resolve`` raises.
"""
from __future__ import annotations

import contextvars

from repro_torch.api.backend import Backend, UnsupportedOpError
from repro_torch.api.policy import DEFAULT_POLICY, ExecutionPolicy

__all__ = ["register", "get_backend", "list_backends", "use", "set_default",
           "current", "resolve", "DEFAULT_BACKEND"]

DEFAULT_BACKEND = "cuda"

_REGISTRY: dict[str, Backend] = {}
_ORDER: list[str] = []  # registration order, for list_backends

# Process-wide default (mutable via set_default); the contextvar holds
# scoped overrides as (backend_name | None, policy | None).
_default: tuple[str, ExecutionPolicy] = (DEFAULT_BACKEND, DEFAULT_POLICY)
_active: contextvars.ContextVar[tuple[str | None, ExecutionPolicy | None] | None] = \
    contextvars.ContextVar("repro_torch_api_active", default=None)


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
    """Pick the backend and policy for one op call; raise if the chosen
    backend cannot run it."""
    cur_be, cur_pol = current()
    be = get_backend(backend) if backend is not None else cur_be
    if not be.supports(op, s=s, t=t):
        raise UnsupportedOpError(
            f"backend {be.name!r} does not support {op} with s={s}, t={t} "
            f"(capabilities: {sorted(be.capabilities)}, bits "
            f"{be.min_bits}..{be.max_bits})")
    return be, policy if policy is not None else cur_pol
