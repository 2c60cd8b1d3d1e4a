"""Durable sessions: manifest, stale-run GC, and coordinator reattach.

The notebook kernel is the coordinator of the worker fleet, so a kernel
restart — the single most common failure in interactive work — used to
destroy the whole session: every worker's REPL namespace, compiled
functions, and device state died with it.  This module makes the
*coordinator* the disposable part and the *fleet* the durable part:

- A **session manifest** (``session.json`` under the shared
  ``NBD_RUN_DIR``) records everything a fresh coordinator needs to
  find and adopt a surviving fleet: world size, the control-plane
  endpoint, per-rank pids, a session token, and a monotonically
  increasing **epoch**.  Written at ``%dist_init``, refreshed on every
  heal, removed by explicit ``%dist_shutdown``.
- :func:`attach` is the reattach path (``%dist_attach`` /
  ``%dist_init --attach``): read the manifest, re-bind the recorded
  control port (orphaned workers dial it back), bump the epoch, adopt
  the worker pids into a :class:`~..manager.ProcessManager`, and run
  the epoch-stamped hello exchange that fences out any stale
  coordinator still holding the previous epoch.
- :func:`gc_runs` sweeps abandoned run directories (old manifest, no
  live pids) so rings/manifests don't accumulate under the tmp root.

Architecture note vs the reference design: the reference coordinator
owns per-worker ROUTER/PUB sockets, so a manifest there would record
per-rank endpoints.  This stack inverts the dial direction — ONE
coordinator listener, workers dial out — so the manifest records the
single control endpoint and the workers' reconnect loop re-reads it to
discover a replacement port if the new coordinator couldn't re-bind
the old one.

Durable sessions are **single-host** by design: pid adoption and the
shared run-dir manifest assume the new coordinator shares a filesystem
and a pid namespace with the fleet (multi-host worlds still recover
via ``%dist_heal`` respawn).
"""

from __future__ import annotations

import json
import os
import secrets
import shutil
import tempfile
import time

from ..utils import knobs

MANIFEST_NAME = "session.json"
LOCK_NAME = "session.lock"
MANIFEST_VERSION = 1

# An attach lock older than this whose holder pid is unknown is
# presumed abandoned (a coordinator that died between claiming the
# epoch and releasing).
ATTACH_LOCK_STALE_S = 60.0

# Default sweep age for stale sibling run dirs (overridable per call /
# NBD_GC_TTL_S): long enough that a lunch-break orphan fleet's run dir
# is never swept under it, short enough that a day of chaos-test runs
# doesn't accumulate forever.
DEFAULT_GC_TTL_S = 6 * 3600.0


def mint_token() -> str:
    """Per-session shared secret: proves a reattaching coordinator is
    resuming THIS session and keeps a sibling session's manifest from
    hijacking an orphaned worker's reconnect loop."""
    return secrets.token_hex(8)


def token_fingerprint(token: str | None) -> str:
    """Short display hash — the token itself never gets printed."""
    if not token:
        return "-"
    import hashlib

    return hashlib.sha256(token.encode()).hexdigest()[:8]


def default_runs_root() -> str:
    # The port's own root (observability/flightrec.py mints run dirs
    # under it): gc_runs here never sweeps the JAX package's runs.
    return os.path.join(tempfile.gettempdir(), "nbd_torch_runs")


def manifest_path(run_dir: str) -> str:
    return os.path.join(run_dir, MANIFEST_NAME)


def make_manifest(*, world_size: int, control_host: str,
                  control_port: int, token: str, epoch: int,
                  pids: dict[int, int], backend: str | None = None,
                  dist_port: int | None = None,
                  bind_host: str | None = None,
                  auth_token: str | None = None,
                  init_line: str | None = None,
                  supervised: bool = False) -> dict:
    """Build a manifest dict.  ``control_host`` is the address workers
    DIAL; ``bind_host`` the address a reattaching coordinator binds
    (they differ on multihost's 0.0.0.0 binds)."""
    return {
        "version": MANIFEST_VERSION,
        "world_size": int(world_size),
        "control": {"host": control_host, "port": int(control_port),
                    "bind_host": bind_host or control_host},
        "token": token,
        "epoch": int(epoch),
        "pids": {str(r): int(p) for r, p in pids.items()},
        "backend": backend,
        "dist_port": dist_port,
        "auth_token": auth_token,
        "init_line": init_line,
        "supervised": bool(supervised),
        "created_ts": time.time(),
    }


def write_manifest(run_dir: str, manifest: dict) -> str:
    """Atomic write (tmp + replace): an orphaned worker polling the
    manifest mid-write must never read a torn file."""
    os.makedirs(run_dir, exist_ok=True)
    manifest = dict(manifest)
    manifest["updated_ts"] = time.time()
    path = manifest_path(run_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, path)
    return path


def read_manifest(run_dir: str) -> dict | None:
    """The run dir's manifest, or None (missing / unreadable / torn —
    a durable-session consumer must treat all three as 'no session')."""
    try:
        with open(manifest_path(run_dir)) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return None
    return m if isinstance(m, dict) else None


def update_manifest(run_dir: str, **fields) -> dict | None:
    """Read-modify-write specific fields (epoch bump, healed pids,
    replacement control endpoint).  Returns the new manifest, or None
    when there was nothing to update."""
    m = read_manifest(run_dir)
    if m is None:
        return None
    m.update(fields)
    write_manifest(run_dir, m)
    return m


def end_session(run_dir: str | None) -> bool:
    """Remove the manifest — explicit fleet teardown (`%dist_shutdown`)
    ends the durable session; a kernel exit does NOT call this, which
    is exactly what leaves the fleet adoptable."""
    if not run_dir:
        return False
    try:
        os.remove(manifest_path(run_dir))
        return True
    except OSError:
        return False


# ----------------------------------------------------------------------
# liveness

def pid_alive(pid: int) -> bool:
    """Signal-0 probe; PermissionError means alive-but-other-uid."""
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except (OverflowError, ValueError, OSError):
        return False
    return True


def live_pids(manifest: dict) -> dict[int, int]:
    """rank -> pid for the manifest entries whose process still runs."""
    out: dict[int, int] = {}
    for r, p in (manifest.get("pids") or {}).items():
        try:
            rank, pid = int(r), int(p)
        except (TypeError, ValueError):
            continue
        if pid_alive(pid):
            out[rank] = pid
    return out


# ----------------------------------------------------------------------
# stale-session GC

def gc_runs(root: str | None = None, *, ttl_s: float | None = None,
            dry_run: bool = False, now: float | None = None) -> dict:
    """Sweep abandoned sibling run dirs under ``root``.

    A run dir is **stale** when its manifest mtime (the dir mtime when
    no manifest exists) is older than ``ttl_s`` AND none of its
    manifest pids are alive — an orphaned-but-within-grace fleet keeps
    its dir no matter how old the manifest is.  The CURRENT run dir
    (``NBD_RUN_DIR``) is never swept, and neither is a dir owned by a
    **live gateway daemon** (pid-liveness probe on its
    ``gateway.json`` — a pooled fleet may sit idle far past any TTL
    while its tenants are away), nor one whose gateway manifest was
    updated within the orphan TTL (a pool mid-resize).  Returns
    ``{"root", "swept": [...], "kept": [...], "kept_why": {dir:
    reason}, "errors": [...]}`` — ``kept_why`` is what ``%dist_gc
    --dry-run`` prints so a skip is explainable; with ``dry_run``
    nothing is removed but ``swept`` still lists the candidates.
    """
    root = root or default_runs_root()
    if ttl_s is None:
        ttl_s = knobs.get_float("NBD_GC_TTL_S", float(DEFAULT_GC_TTL_S))
    now = now if now is not None else time.time()
    current = knobs.get_str("NBD_RUN_DIR")
    current = os.path.realpath(current) if current else None
    swept: list[str] = []
    kept: list[str] = []
    kept_why: dict[str, str] = {}
    errors: list[str] = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        names = []
    for name in names:
        d = os.path.join(root, name)
        if not os.path.isdir(d):
            continue
        if current and os.path.realpath(d) == current:
            kept.append(d)
            kept_why[d] = "current session's run dir (NBD_RUN_DIR)"
            continue
        try:
            # Live gateway daemons protect their run dir regardless of
            # age: an idle pool's manifest can be arbitrarily old while
            # the daemon (and its tenants' parked state) is live.
            from ..gateway.daemon import (gateway_alive,
                                          read_gateway_manifest)
            gw = read_gateway_manifest(d)
            if gateway_alive(gw):
                kept.append(d)
                kept_why[d] = (f"live gateway daemon "
                               f"(pid {gw.get('pid')})")
                continue
            if gw is not None:
                # Mid-resize/restart window: a resize is a drain +
                # fleet restart under a bumped epoch, during which the
                # daemon pid probe can race the restart and read
                # "dead".  A manifest whose epoch/heartbeat was bumped
                # within the orphan TTL is a pool in transition, not
                # an abandoned one.
                gw_ts = gw.get("updated_ts") or gw.get("created_ts") \
                    or 0.0
                orphan_ttl = knobs.get_float("NBD_ORPHAN_TTL_S", 600.0)
                try:
                    recent = (now - float(gw_ts)) <= orphan_ttl
                except (TypeError, ValueError):
                    recent = False
                if recent:
                    kept.append(d)
                    kept_why[d] = (
                        f"gateway manifest updated "
                        f"{now - float(gw_ts):.0f}s ago (epoch "
                        f"{gw.get('epoch', '?')}) — resize/restart "
                        f"window, within orphan ttl "
                        f"{orphan_ttl:.0f}s")
                    continue
            mpath = manifest_path(d)
            ref = mpath if os.path.exists(mpath) else d
            age = now - os.path.getmtime(ref)
            manifest = read_manifest(d)
            alive = live_pids(manifest) if manifest else {}
            if age > ttl_s and not alive:
                if not dry_run:
                    shutil.rmtree(d, ignore_errors=True)
                swept.append(d)
            else:
                kept.append(d)
                if alive:
                    kept_why[d] = (f"live worker pid(s) "
                                   f"{sorted(alive.values())}")
                else:
                    kept_why[d] = (f"younger than ttl "
                                   f"({age:.0f}s < {ttl_s:.0f}s)")
        except OSError as e:
            errors.append(f"{d}: {e}")
    return {"root": root, "ttl_s": ttl_s, "swept": swept, "kept": kept,
            "kept_why": kept_why, "errors": errors, "dry_run": dry_run}


# ----------------------------------------------------------------------
# attach lock: the epoch bump is a read-modify-write on the manifest,
# and two kernels racing %dist_attach must not both claim epoch N+1
# (both would pass the workers' fence and split-brain the fleet).
# O_EXCL on a lockfile serializes the claim; durable sessions are
# single-host by design, so one filesystem's O_EXCL is authoritative.

def _acquire_attach_lock(run_dir: str) -> str:
    path = os.path.join(run_dir, LOCK_NAME)
    for _ in range(3):
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY,
                         0o644)
        except FileExistsError:
            try:
                holder = int(open(path).read().strip() or 0)
            except (OSError, ValueError):
                holder = 0
            try:
                age = time.time() - os.path.getmtime(path)
            except OSError:
                continue  # vanished between open and stat: retry
            if (holder and not pid_alive(holder)) \
                    or age > ATTACH_LOCK_STALE_S:
                # Abandoned claim (holder died mid-attach): break it.
                try:
                    os.remove(path)
                except OSError:
                    pass
                continue
            raise RuntimeError(
                f"another coordinator (pid {holder or '?'}) is "
                f"attaching to this session right now — retry in a "
                f"moment, or remove {path} if it is stale")
        os.write(fd, str(os.getpid()).encode())
        os.close(fd)
        return path
    raise RuntimeError(f"could not acquire {path}")


def _release_attach_lock(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


# ----------------------------------------------------------------------
# reattach

def discover_run_dir() -> str | None:
    """Best reattach candidate when the caller names none: the env run
    dir if it holds a manifest, else the newest sibling under the runs
    root whose manifest still has live pids."""
    env = knobs.get_str("NBD_RUN_DIR")
    if env and read_manifest(env) is not None:
        return env
    root = default_runs_root()
    best: tuple[float, str] | None = None
    try:
        names = os.listdir(root)
    except OSError:
        return None
    for name in names:
        d = os.path.join(root, name)
        m = read_manifest(d)
        if m is None or not live_pids(m):
            continue
        ts = m.get("updated_ts") or 0.0
        if best is None or ts > best[0]:
            best = (ts, d)
    return best[1] if best else None


def attach(run_dir: str | None = None, *, attach_timeout: float = 90.0,
           request_timeout: float | None = None, retry=None):
    """Reattach a fresh coordinator to a surviving fleet.

    Reads the manifest, binds the recorded control port (falling back
    to an ephemeral one — published back to the manifest so orphaned
    workers' reconnect loops discover it), bumps the session epoch,
    adopts the recorded pids, waits for every rank to dial back in,
    and runs the hello exchange that hands the fleet to THIS
    coordinator (token verified; the bumped epoch fences any stale
    coordinator's frames out at the workers).

    Returns ``(comm, pm, manifest, hello)`` where ``hello`` maps
    rank -> hello response Message (``data["parked"]`` lists mailbox
    msg_ids awaiting :func:`drain_mailboxes`).  On any failure the
    adopted fleet is left RUNNING (quiesce + listener close only) —
    a failed attach must never kill the session it failed to join.
    """
    from ..manager import ProcessManager, wait_until_ready
    from ..messaging import CommunicationManager

    run_dir = run_dir or discover_run_dir()
    if not run_dir:
        raise RuntimeError(
            "no session to attach: pass a run dir, or set NBD_RUN_DIR "
            f"(no live manifest under {default_runs_root()})")
    if read_manifest(run_dir) is None:
        raise RuntimeError(f"no session manifest in {run_dir}")
    # Serialize the epoch claim: two kernels racing attach must not
    # both compute epoch N+1 (both would pass the workers' fence).
    lock = _acquire_attach_lock(run_dir)
    try:
        manifest = read_manifest(run_dir)
        if manifest is None:
            raise RuntimeError(f"no session manifest in {run_dir}")
        pids = {int(r): int(p) for r, p in
                (manifest.get("pids") or {}).items()}
        world = int(manifest.get("world_size") or len(pids))
        alive = live_pids(manifest)
        if len(alive) < world:
            dead = sorted(set(pids) - set(alive))
            raise RuntimeError(
                f"fleet is not intact: ranks {dead} have no live "
                f"process (orphan TTL expired, or they crashed) — "
                f"%dist_init to start fresh, %dist_gc to sweep the "
                f"remains")
        # Future children (heals) and this process's flight ring must
        # land in the adopted session's run dir, not a freshly minted
        # one — restored on ANY failure below, so a failed attach
        # doesn't leave this kernel pointed at (and a later %dist_init
        # clobbering) a fleet it never joined.
        prev_run_dir = knobs.get_str("NBD_RUN_DIR")
        os.environ["NBD_RUN_DIR"] = run_dir
        comm = None
        try:
            epoch = int(manifest.get("epoch") or 0) + 1
            ctl = manifest.get("control") or {}
            dial_host = ctl.get("host") or "127.0.0.1"
            bind_host = ctl.get("bind_host") or dial_host
            token = manifest.get("token")
            auth = manifest.get("auth_token")
            kw = dict(num_workers=world, host=bind_host,
                      timeout=request_timeout, auth_token=auth,
                      retry=retry, session_token=token,
                      session_epoch=epoch)
            try:
                comm = CommunicationManager(
                    port=int(ctl.get("port") or 0), **kw)
            except OSError:
                # The old port was taken (often by the stale
                # coordinator still holding it): bind ephemeral and
                # let the manifest redirect the workers' reconnect
                # loops.
                comm = CommunicationManager(port=0, **kw)
            # Publish endpoint + epoch BEFORE waiting: orphaned
            # workers poll the manifest between reconnect attempts.
            update_manifest(run_dir, epoch=epoch,
                            control={"host": dial_host,
                                     "port": comm.port,
                                     "bind_host": bind_host})
        except Exception:
            if prev_run_dir is None:
                os.environ.pop("NBD_RUN_DIR", None)
            else:
                os.environ["NBD_RUN_DIR"] = prev_run_dir
            if comm is not None:
                comm.shutdown()
            raise
    finally:
        _release_attach_lock(lock)
    pm = ProcessManager()
    pm.adopt(pids, backend=manifest.get("backend"),
             dist_port=manifest.get("dist_port"))
    pm.add_death_callback(lambda r, rc: comm.mark_worker_dead(r))
    try:
        wait_until_ready(comm, pm, attach_timeout)
        hello = comm.send_to_all(
            "hello", {"token": token, "epoch": epoch}, timeout=30)
        errs = {r: m.data.get("error") for r, m in hello.items()
                if isinstance(m.data, dict) and m.data.get("error")}
        if errs:
            raise RuntimeError(f"hello rejected by ranks {errs}")
    except Exception:
        # Detach WITHOUT killing the fleet: stop the death monitor and
        # close the listener; the workers stay orphaned and adoptable.
        pm.quiesce()
        pm.processes.clear()
        pm.io.clear()
        comm.shutdown()
        if prev_run_dir is None:
            os.environ.pop("NBD_RUN_DIR", None)
        else:
            os.environ["NBD_RUN_DIR"] = prev_run_dir
        raise
    update_manifest(run_dir, attached_ts=time.time())
    return comm, pm, read_manifest(run_dir) or manifest, hello


def drain_mailboxes(comm, *, timeout: float = 30.0) -> dict:
    """Claim every parked result from every rank's mailbox — exactly
    once (a second drain returns empty dicts; a redelivered drain is
    answered from the workers' replay caches).  Returns
    ``{rank: {msg_id: result_data}}``."""
    resps = comm.send_to_all("mailbox", {"action": "drain"},
                             timeout=timeout)
    return {r: (m.data or {}).get("results") or {}
            for r, m in resps.items()}


def refresh_after_heal(comm, pm) -> dict | None:
    """Manifest upkeep after a supervisor heal: the respawned fleet's
    pids/endpoint replace the dead ones, or a later ``%dist_attach``
    would adopt corpses.  No-op (None) without a run dir or manifest."""
    run_dir = knobs.get_str("NBD_RUN_DIR")
    if not run_dir:
        return None
    pids = {}
    for r, p in getattr(pm, "processes", {}).items():
        pid = getattr(p, "pid", None)
        if pid is not None:
            pids[str(r)] = int(pid)
    m = read_manifest(run_dir)
    if m is None:
        return None
    ctl = dict(m.get("control") or {})
    ctl["port"] = comm.port
    return update_manifest(run_dir, pids=pids, control=ctl,
                           world_size=comm.num_workers,
                           epoch=max(int(m.get("epoch") or 0),
                                     int(getattr(comm, "session_epoch", 0)
                                         or 0)))
