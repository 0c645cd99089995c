"""Persistent, content-addressed artifact store for extracted Events (a
port of :mod:`repro.analysis.store`).

Recording a workload to read its PMU-analogue counters (Sec. 3.1, Table 1)
is the expensive step of the compiled source, and the counters themselves
are tiny, chip-independent JSON.  This module persists them across
*processes*: each workload is keyed by a **fingerprint** of what
determines its recording —

  * the workload name,
  * the shapes and dtypes of its example arguments (values do not change
    which operators run, shapes do),
  * a structural hash of the callable's bytecode (code, consts, names,
    closure values, defaults, ``functools.partial`` bindings and
    ``__wrapped__``, which covers ``KernelOps``, and a ``KernelOps``'s
    active tuned config), and
  * the device count, the torch version and the cost model's version,

so a re-run of ``analyze`` / ``analyze_sweep`` / the analysis service in a
fresh process gets a store hit and records nothing, while changing an
input shape, a dtype or the function body changes the fingerprint.

Storage is one JSON file per fingerprint under a directory,
version-checked: writes go through a temp file and ``os.replace`` so
concurrent processes can share one directory, and unreadable, truncated
or stale-version files are dropped as misses by
:meth:`ArtifactStore.get_json` and skipped (never deleted) by
:meth:`ArtifactStore.iter_json`.  The layout and payload stamps
(``version``, ``fingerprint``, ``workload``, ``events``) are the
reference's, so either package reads a directory the other wrote: the
perf ledger (:mod:`repro_torch.perf.ledger`) and triage's tuning-record
scan run on this layer too.

The port's default directory is the ``torch/`` subdirectory of
``$REPRO_ARTIFACT_DIR`` (default ``~/.cache/repro/artifacts``), and its
fingerprints carry ``torch=<version>`` where the reference's carry the jax
version, so the two packages' ``Events`` never answer for each other.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import tempfile
from typing import Any, Dict, Iterator, Optional, Tuple

from repro_torch.core.counters import Events

STORE_VERSION = 1

#: Environment variable overriding the default store directory's parent.
STORE_DIR_ENV = "REPRO_ARTIFACT_DIR"

#: The port's subdirectory of the artifact directory.
PORT_SUBDIR = "torch"


def _default_dir() -> str:
    base = os.environ.get(
        STORE_DIR_ENV,
        os.path.join(os.path.expanduser("~"), ".cache", "repro", "artifacts"),
    )
    return os.path.join(base, PORT_SUBDIR)


# ---------------------------------------------------------------------------
# Workload fingerprinting
# ---------------------------------------------------------------------------


def _code_token(fn: Any, parts: list, seen: set) -> None:
    """Append a structural description of ``fn``'s bytecode to ``parts``.

    Uses co_code + names + nested code objects (NOT memory addresses or
    source locations), so the token is stable across processes for the same
    source — including lambdas, which ``__qualname__`` alone cannot
    distinguish.
    """
    code = getattr(fn, "__code__", None)
    if code is None:
        # callables may advertise extra behavioral state (a KernelOps with
        # an active tuned config launches another variant)
        extra = getattr(fn, "fingerprint_extra", None)
        if extra:
            parts.append(str(extra))
        # KernelOps (functools.update_wrapper) carry the wrapper here
        wrapped = getattr(fn, "__wrapped__", None)
        if wrapped is not None and id(wrapped) not in seen:
            seen.add(id(wrapped))
            _code_token(wrapped, parts, seen)
            return
        parts.append(getattr(fn, "__qualname__", None) or repr(type(fn)))
        return
    stack = [code]
    while stack:
        c = stack.pop()
        if id(c) in seen:
            continue
        seen.add(id(c))
        parts.append(c.co_code.hex())
        parts.append(repr(c.co_names))
        parts.append(repr(c.co_varnames))
        for const in c.co_consts:
            if hasattr(const, "co_code"):
                stack.append(const)
            else:
                parts.append(repr(const))
    closure = getattr(fn, "__closure__", None)
    if closure:
        for cell in closure:
            try:
                _value_token(cell.cell_contents, parts, seen)
            except ValueError:  # empty cell
                parts.append("<empty-cell>")
    # default-argument values are behavior, but live outside co_consts
    for d in getattr(fn, "__defaults__", None) or ():
        _value_token(d, parts, seen)
    for k, v in sorted((getattr(fn, "__kwdefaults__", None) or {}).items()):
        parts.append(k)
        _value_token(v, parts, seen)


def _value_token(value: Any, parts: list, seen: set) -> None:
    """Token for a closure-cell / default / partial-bound value.

    Tensors contribute their shape and dtype: a tensor's ``repr`` elides
    both when it is large, so two different-shaped captures would collide,
    and shapes, not values, decide which operators run.  Callables recurse
    into their bytecode: their ``repr`` embeds a memory address, which would
    make fingerprints process-local.
    """
    if hasattr(value, "shape") and hasattr(value, "dtype"):
        parts.append(_arg_signature(value))
        return
    if callable(value):
        if id(value) not in seen:
            seen.add(id(value))
            _code_token(value, parts, seen)
        return
    parts.append(repr(value)[:256])


def fn_token(fn: Any) -> str:
    """Cross-process-stable identity token for a workload callable."""
    parts: list = []
    seen: set = set()
    f = fn
    while isinstance(f, functools.partial):
        for a in f.args:
            _value_token(a, parts, seen)
        for k, v in sorted((f.keywords or {}).items()):
            parts.append(k)
            _value_token(v, parts, seen)
        f = f.func
    _code_token(f, parts, seen)
    return "|".join(parts)


def _arg_signature(arg: Any) -> str:
    """Abstract (shape, dtype) signature of one example argument."""
    shape = getattr(arg, "shape", None)
    dtype = getattr(arg, "dtype", None)
    if shape is not None:
        return f"{tuple(shape)}:{dtype}"
    if isinstance(arg, dict):
        items = ",".join(f"{k}={_arg_signature(v)}" for k, v in sorted(arg.items()))
        return "{" + items + "}"
    if isinstance(arg, (list, tuple)):
        return "(" + ",".join(_arg_signature(v) for v in arg) + ")"
    return f"{type(arg).__name__}:{arg!r}"


#: Public alias: other content-addressed layers key on the same abstract
#: argument signatures.
arg_signature = _arg_signature


@functools.lru_cache(maxsize=1)
def _compiler_token() -> str:
    """The torch version and the cost model's: either changes which
    operators a run dispatches or what the walk charges them, so it must
    change the address."""
    import torch

    from repro_torch.core.op_cost import COST_MODEL_VERSION

    return f"torch={torch.__version__},cost={COST_MODEL_VERSION}"


def workload_fingerprint(wl: Any) -> str:
    """Content address of a Workload's recorded events.

    name + abstract arg shapes/dtypes + fn hash + n_devices + torch and
    cost-model versions, hex-digested.  Materializes lazy example args
    (tensor construction) but never records.
    """
    h = hashlib.sha256()
    h.update(f"v{STORE_VERSION}|{_compiler_token()}|".encode())
    h.update(f"{wl.name}|n_devices={wl.n_devices}|".encode())
    for a in wl.example_args():
        h.update(_arg_signature(a).encode())
        h.update(b";")
    h.update(fn_token(wl.fn).encode())
    return h.hexdigest()[:32]


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------

class ArtifactStore:
    """Disk-backed, content-addressed map fingerprint -> JSON payload.

    The generic layer is :meth:`get_json` / :meth:`put_json`; on top of it
    sit :meth:`get` / :meth:`put` for extracted :class:`Events`.
    ``hits`` / ``misses`` / ``puts`` / ``dropped_corrupt`` are exposed for
    tests and cost accounting.  All operations tolerate concurrent writers:
    puts go through a temp file + ``os.replace``, and any file that fails to
    parse is removed and reported as a miss.
    """

    def __init__(self, cache_dir: Optional[str] = None) -> None:
        self.cache_dir = cache_dir or _default_dir()
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.dropped_corrupt = 0

    def path_for(self, fingerprint: str) -> str:
        return os.path.join(self.cache_dir, f"{fingerprint}.json")

    def _drop_corrupt(self, path: str) -> None:
        """Remove an unreadable/stale entry and account it as a miss."""
        self.dropped_corrupt += 1
        self.misses += 1
        try:
            os.remove(path)
        except OSError:
            pass

    def discard(self, fingerprint: str) -> None:
        """Corrupt-entry drop for typed layers that fail to decode a payload
        ``get_json`` already accepted: reverses that hit and accounts the
        entry as dropped+missed (callers must not adjust counters)."""
        self.hits -= 1
        self._drop_corrupt(self.path_for(fingerprint))

    def get_json(self, fingerprint: str) -> Optional[Dict[str, Any]]:
        """Raw payload for ``fingerprint`` or None; never raises.

        Corrupt / truncated / stale-version files are deleted and reported
        as misses — the typed layers above recompute and heal the entry.
        """
        path = self.path_for(fingerprint)
        try:
            with open(path) as f:
                payload = json.load(f)
            if payload.get("version") != STORE_VERSION:
                raise ValueError(f"store version {payload.get('version')}")
        except FileNotFoundError:
            self.misses += 1
            return None
        except (ValueError, KeyError, TypeError, OSError, AttributeError):
            self._drop_corrupt(path)
            return None
        self.hits += 1
        return payload

    def get(self, fingerprint: str) -> Optional[Events]:
        payload = self.get_json(fingerprint)
        if payload is None:
            return None
        try:
            return Events.from_dict(payload["events"])
        except (ValueError, KeyError, TypeError, AttributeError):
            self.discard(fingerprint)  # reverses the get_json hit
            return None

    def put_json(self, fingerprint: str, payload: Dict[str, Any]) -> str:
        """Atomically persist ``payload`` (version/fingerprint filled in)."""
        os.makedirs(self.cache_dir, exist_ok=True)
        path = self.path_for(fingerprint)
        # the store's stamps must win over any same-named payload keys, or a
        # colliding key would make every later get_json() drop the entry
        payload = {**payload, "version": STORE_VERSION, "fingerprint": fingerprint}
        fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)  # atomic vs concurrent readers/writers
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        self.puts += 1
        return path

    def put(self, fingerprint: str, events: Events, *, workload: str = "") -> str:
        return self.put_json(
            fingerprint, {"workload": workload, "events": events.to_dict()}
        )

    def iter_json(self, namespace: str = "") -> Iterator[Tuple[str, Dict[str, Any]]]:
        """Yield ``(fingerprint, payload)`` for every readable entry.

        ``namespace`` selects a subdirectory of this store's ``cache_dir``
        (e.g. ``"tuning"`` from the root store); empty means the store's
        own directory.  Enumeration is read-only and corrupt-*skipping*: a
        truncated, unparseable, or stale-version file is passed over, never
        deleted — a concurrent writer may be mid-rename.  Entries come back
        in filename-sorted order.
        """
        root = os.path.join(self.cache_dir, namespace) if namespace else self.cache_dir
        try:
            names = os.listdir(root)
        except OSError:
            return
        for fname in sorted(names):
            if not fname.endswith(".json"):
                continue
            try:
                with open(os.path.join(root, fname)) as f:
                    payload = json.load(f)
                if payload.get("version") != STORE_VERSION:
                    continue
                fingerprint = str(payload["fingerprint"])
            except (ValueError, KeyError, TypeError, OSError, AttributeError):
                continue
            yield fingerprint, payload

    def entries(self) -> Dict[str, str]:
        """fingerprint -> workload name for every readable entry."""
        return {
            fp: payload.get("workload", "")
            for fp, payload in self.iter_json()
        }

    def clear(self) -> int:
        """Delete every entry; returns the number of files removed."""
        n = 0
        try:
            names = os.listdir(self.cache_dir)
        except OSError:
            return 0
        for fname in names:
            if fname.endswith(".json"):
                try:
                    os.remove(os.path.join(self.cache_dir, fname))
                    n += 1
                except OSError:
                    pass
        return n

    def __repr__(self) -> str:
        return (
            f"ArtifactStore({self.cache_dir!r}, hits={self.hits}, "
            f"misses={self.misses}, puts={self.puts})"
        )


@functools.lru_cache(maxsize=None)
def _store_for(cache_dir: str) -> ArtifactStore:
    return ArtifactStore(cache_dir)


def default_store() -> ArtifactStore:
    """Process-wide store for the default directory, resolved at *call*
    time (one memoized store per directory), so tests can point it at a
    temp dir through ``$REPRO_ARTIFACT_DIR``."""
    return _store_for(_default_dir())
