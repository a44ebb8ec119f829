"""Preemption notices and capacity grants: the cluster's advance warnings
(the port's copy of ``tpu_trainer/utils/preemption.py``).

SIGTERM (``training/cli.py``'s handler) is the *last* warning a preempted
host gets — by then the kill deadline is already running. Real schedulers
publish the decision earlier: GCE/TPU VMs flip the metadata server's
``instance/preempted`` value (and maintenance-event key) up to tens of
seconds before the ACPI shutdown lands. Polling that gives the trainer a
*proactive* drain — checkpoint at the next step boundary, deregister from
the supervisor, exit clean — instead of a reactive scramble under the
``--preemption_grace_s`` deadline. Recovery then rolls back zero steps:
the drain checkpoint IS the step the reformed run resumes at.

Notice sources (``build_notice_source``):

- ``file:<path>`` — a notice file: the notice has arrived when the file
  exists. JSON content may carry ``{"deadline_s": ...}`` (seconds of grace
  from notice receipt) or ``{"deadline_unix": ...}``. This is the form
  chaos tests and external agents use.
- ``http://...`` / ``https://...`` — poll a GCE-metadata-shaped endpoint
  with the ``Metadata-Flavor: Google`` header; a 200 whose body is
  ``TRUE``/``1`` (the real server's ``instance/preempted`` answer) is a
  notice.
- ``metadata`` — shorthand for the real GCE endpoint (GCE_METADATA_URL).

Polls are throttled (``poll_interval_s``) because the HTTP probe is a
network round-trip on the step path, and sticky: once a notice is seen it
is never un-seen (a preemption decision does not revert).

The inverse signal lives here too: **capacity grants**. The supervisor
(``training/elastic.py``) exports ``TPU_TRAINER_CAPACITY_FILE``; an
external agent — or the ``return_host`` chaos fault — writes the number of
re-granted hosts there, and the supervisor's ``--allow_grow`` probe
consumes it to re-expand the world.
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Optional

GCE_METADATA_URL = ("http://metadata.google.internal/computeMetadata/v1/"
                    "instance/preempted")
_HTTP_TIMEOUT_S = 0.75


@dataclass
class PreemptionNotice:
    """One received notice: where it came from and how long until the kill
    (``deadline_unix`` is None when the source carries no deadline — the
    drain then runs under ``--preemption_grace_s`` alone)."""
    source: str
    received_unix: float
    deadline_unix: Optional[float] = None

    def remaining_s(self, now: Optional[float] = None) -> Optional[float]:
        if self.deadline_unix is None:
            return None
        return self.deadline_unix - (time.time() if now is None else now)


class NoticeSource:
    """Base poller: throttled, sticky. Subclasses implement ``_probe``."""

    def __init__(self, poll_interval_s: float = 1.0, clock=time.monotonic):
        self.poll_interval_s = float(poll_interval_s)
        self._clock = clock
        self._last_poll: Optional[float] = None
        self._notice: Optional[PreemptionNotice] = None

    def poll(self) -> Optional[PreemptionNotice]:
        """The received notice, probing the source at most once per
        ``poll_interval_s`` (sticky once seen)."""
        if self._notice is not None:
            return self._notice
        now = self._clock()
        if (self._last_poll is not None
                and now - self._last_poll < self.poll_interval_s):
            return None
        self._last_poll = now
        self._notice = self._probe()
        return self._notice

    def _probe(self) -> Optional[PreemptionNotice]:
        raise NotImplementedError


class FileNoticeSource(NoticeSource):
    """Notice == the file exists. Empty or non-JSON content is still a
    notice (touching the file is the minimal viable agent); JSON content
    may carry a deadline."""

    def __init__(self, path: str, **kw):
        super().__init__(**kw)
        self.path = path

    def _probe(self) -> Optional[PreemptionNotice]:
        if not os.path.exists(self.path):
            return None
        received = time.time()
        deadline = None
        try:
            with open(self.path) as fh:
                body = json.load(fh)
            if isinstance(body, dict):
                if body.get("deadline_unix") is not None:
                    deadline = float(body["deadline_unix"])
                elif body.get("deadline_s") is not None:
                    deadline = received + float(body["deadline_s"])
        except (OSError, ValueError):
            pass
        return PreemptionNotice(source=f"file:{self.path}",
                                received_unix=received,
                                deadline_unix=deadline)


class MetadataNoticeSource(NoticeSource):
    """Poll a GCE-metadata-shaped HTTP endpoint. Unreachable/erroring
    endpoints are not notices — a flaky metadata server must not drain a
    healthy run."""

    TRUTHY = frozenset({"TRUE", "1", "YES"})

    def __init__(self, url: str, **kw):
        super().__init__(**kw)
        self.url = url

    def _probe(self) -> Optional[PreemptionNotice]:
        req = urllib.request.Request(
            self.url, headers={"Metadata-Flavor": "Google"})
        try:
            with urllib.request.urlopen(req, timeout=_HTTP_TIMEOUT_S) as resp:
                body = resp.read(256).decode("utf-8", "replace").strip()
        except (urllib.error.URLError, OSError, ValueError):
            return None
        if body.upper() in self.TRUTHY:
            return PreemptionNotice(source=f"http:{self.url}",
                                    received_unix=time.time())
        return None


def build_notice_source(spec: Optional[str],
                        poll_interval_s: float = 1.0
                        ) -> Optional[NoticeSource]:
    """``file:<path>`` | ``http(s)://<url>`` | ``metadata`` | None.

    SIGTERM needs no source here: the signal handler in ``training/cli.py``
    is the always-on fallback, and the drain path treats a polled notice
    and a caught SIGTERM identically (the notice just arrives earlier)."""
    if not spec:
        return None
    if spec == "metadata":
        return MetadataNoticeSource(GCE_METADATA_URL,
                                    poll_interval_s=poll_interval_s)
    if spec.startswith(("http://", "https://")):
        return MetadataNoticeSource(spec, poll_interval_s=poll_interval_s)
    if spec.startswith("file:"):
        return FileNoticeSource(spec[len("file:"):],
                                poll_interval_s=poll_interval_s)
    raise ValueError(
        f"bad preempt notice spec {spec!r}: expected 'file:<path>', an "
        f"http(s) URL, or 'metadata'")


# --- capacity grants (the grow half of elasticity) ----------------------

def read_capacity(path: Optional[str]) -> int:
    """Hosts currently re-granted beyond the running world (0 when the file
    is absent, torn, or mid-write — a torn grant is re-read next probe)."""
    if not path:
        return 0
    try:
        with open(path) as fh:
            body = json.load(fh)
        return max(0, int(body.get("hosts", 0)))
    except (OSError, ValueError, AttributeError):
        return 0


def grant_capacity(path: str, hosts: int = 1) -> int:
    """Add ``hosts`` to the grant file (atomic replace; read-modify-write is
    safe because the supervisor only ever *consumes* and grants come from a
    single agent). Returns the new total."""
    total = read_capacity(path) + int(hosts)
    _write_capacity(path, total)
    return total


def consume_capacity(path: Optional[str], hosts: int) -> int:
    """Subtract ``hosts`` the supervisor just admitted into the world.
    Returns the remaining grant."""
    if not path:
        return 0
    left = max(0, read_capacity(path) - int(hosts))
    _write_capacity(path, left)
    return left


def _write_capacity(path: str, hosts: int) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump({"hosts": int(hosts), "unix": time.time()}, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
