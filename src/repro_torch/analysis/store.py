"""The JSON layer of the persistent, content-addressed artifact store (a
port of :mod:`repro.analysis.store`'s ``ArtifactStore``).

One JSON file per fingerprint under a directory, version-checked: writes
go through a temp file and ``os.replace`` so concurrent processes can
share one directory, and unreadable, truncated or stale-version files are
dropped as misses by :meth:`ArtifactStore.get_json` and skipped (never
deleted) by :meth:`ArtifactStore.iter_json`.  The layout and payload
stamps (``version``, ``fingerprint``) are the reference's, so either
package reads a directory the other wrote: the perf ledger
(:mod:`repro_torch.perf.ledger`) and triage's tuning-record scan run on
this layer.

The port's default directory is the ``torch/`` subdirectory of
``$REPRO_ARTIFACT_DIR`` (default ``~/.cache/repro/artifacts``), so the
two packages' default ledgers never become each other's baselines; an
explicit directory reads either package's files.  The ``Events`` half of
the reference's store (``get``/``put``, workload fingerprints) and its
``ArtifactCache`` come with the compiled event source, ROADMAP 1.17.
"""

from __future__ import annotations

import functools
import json
import os
import tempfile
from typing import Any, Dict, Iterator, Optional, Tuple

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


class ArtifactStore:
    """Disk-backed, content-addressed map fingerprint -> JSON payload.

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
