"""Kernel-side tenant connection to a gateway pool (counterpart of
``nbdistributed_tpu/gateway/client.py``).

A :class:`TenantClient` is what ``%dist_attach --tenant`` holds: one
authenticated connection to the gateway's tenant plane, a reader
thread correlating replies by message id, and the tenant's session
identity (token + epoch) from the ``tenant_hello`` exchange.  Every
request after the hello is epoch-stamped, so a crashed kernel's stale
connection can never act on a tenant that has since reattached —
the durable session's stale-coordinator fence, client side.

The client is deliberately thin: admission, queueing, shedding, and
parking all happen gateway-side; this class just surfaces the
explicit verdicts (``on_queued`` fires with the full backpressure
notice dict — ``position`` plus, under effects admission, the
``reason`` naming why the cell was serialized;
:class:`CellSubmitError` carries a shed/rejected verdict, and
:meth:`drain` claims parked results exactly once on reattach).
"""

from __future__ import annotations

import secrets
import threading
import time

from ..messaging.codec import Message
from ..messaging.transport import TransportError, WorkerChannel


class GatewayGone(RuntimeError):
    """The tenant-plane connection died (gateway stopped/crashed)."""


class CellSubmitError(RuntimeError):
    """The pool refused the cell with an explicit verdict (shed under
    overload, or rejected at the tenant in-flight cap)."""

    def __init__(self, verdict: dict):
        super().__init__(verdict.get("error")
                         or f"cell {verdict.get('status')}")
        self.verdict = verdict


class TenantFenced(RuntimeError):
    """This connection's tenant epoch is stale: the tenant reattached
    from another kernel, which fenced this one out (the durable session's
    stale-coordinator rejection, scoped to one tenant)."""


class _Call:
    __slots__ = ("event", "reply", "notices", "late_cb", "notice_cb")

    def __init__(self):
        self.event = threading.Event()
        self.reply: Message | None = None
        self.notices: list[dict] = []
        # Set when the waiter gave up (interrupt): the reader invokes
        # it with the terminal reply instead of dropping the result.
        self.late_cb = None
        # Interim "queued" frames fire this from the reader thread —
        # the waiter no longer fast-polls for them (a multi-hour cell
        # used to wake its kernel thread 10x/s just in case).
        self.notice_cb = None


class TenantClient:
    """One tenant's live connection to the pool."""

    def __init__(self, host: str, port: int, name: str, *,
                 token: str | None = None,
                 pool_token: str | None = None,
                 priority: int | None = None,
                 hello_timeout: float = 30.0, on_stream=None):
        self.name = name
        # The preamble "rank" is this connection's client id — unique
        # per connection so the gateway can route replies; never a
        # worker rank (the tenant plane has no ranks).
        self.client_id = secrets.randbelow((1 << 30) - (1 << 20)) \
            + (1 << 20)
        self.on_stream = on_stream    # callable(rank, data) or None
        # callable(data) or None — fires (reader thread) when the
        # gateway parks a result AFTER this connection's hello (a cell
        # that was in flight across the reattach finished): the hello's
        # parked list predates it, so this nudge is the only signal to
        # drain.  Do NOT call request() from inside it (the reader
        # delivers the reply it would wait on) — hand off to a thread.
        self.on_parked = None
        # callable(data) or None — fires (reader thread) for serving-
        # plane pushes: incremental ``serve_tokens`` notices
        # ({"rid", "o", "t"}) and live terminal ``serve_done`` results
        # ({"rid", "status", "tokens"}).  Same reader-thread caveats
        # as on_parked.
        self.on_serve = None
        self._ch = WorkerChannel(host, port, rank=self.client_id,
                                 auth_token=pool_token,
                                 connect_timeout=min(hello_timeout,
                                                     30.0))
        self._lock = threading.Lock()
        self._calls: dict[str, _Call] = {}
        self._dead: Exception | None = None
        self._closed = False
        self.token = token
        self.epoch = 0
        self.parked: list[str] = []
        self.world_size = 0
        self.policy: dict = {}
        self.attach_status = ""
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"nbd-tenant-{name}",
                                        daemon=True)
        self._reader.start()
        try:
            hello = self.request(
                "tenant_hello",
                {"tenant": name, "token": token, "priority": priority},
                timeout=hello_timeout, stamp_epoch=False)
        except BaseException:
            # A hello that times out or dies mid-flight must not leak
            # the socket + reader thread into the kernel process.
            self.close()
            raise
        data = hello.data or {}
        if data.get("error"):
            self.close()
            raise RuntimeError(f"tenant attach refused: "
                               f"{data['error']}")
        self.token = data.get("token")
        self.epoch = int(data.get("epoch") or 0)
        self.parked = list(data.get("parked") or ())
        self.world_size = int(data.get("world_size") or 0)
        self.policy = dict(data.get("policy") or {})
        self.attach_status = data.get("status") or "admitted"

    # ------------------------------------------------------------------

    def _read_loop(self) -> None:
        while True:
            try:
                msg = self._ch.recv()
            except Exception as e:
                with self._lock:
                    self._dead = e if not self._closed else None
                    calls = list(self._calls.values())
                    self._calls.clear()
                for c in calls:
                    c.event.set()
                return
            if msg.msg_type == "stream_output":
                cb = self.on_stream
                if cb is not None:
                    try:
                        cb(msg.rank, msg.data or {})
                    except Exception:
                        pass
                continue
            if msg.msg_type == "parked_notice":
                cb = self.on_parked
                if cb is not None:
                    try:
                        cb(msg.data or {})
                    except Exception:
                        pass
                continue
            if msg.msg_type in ("serve_tokens", "serve_done"):
                # Serving-plane pushes are uncorrelated (no waiter):
                # token stream notices while a request decodes, and a
                # live terminal result.  (A terminal result with NO
                # live connection parks instead and arrives through
                # drain().)
                cb = self.on_serve
                if cb is not None:
                    try:
                        cb(dict(msg.data or {}))
                    except Exception:
                        pass
                continue
            with self._lock:
                c = self._calls.get(msg.msg_id)
            if c is None:
                continue  # late reply to an abandoned request
            if msg.msg_type == "queued":
                c.notices.append(msg.data or {})
                cb = c.notice_cb
                if cb is not None:
                    try:
                        cb(msg.data or {})
                    except Exception:
                        pass
                continue
            # reply-set + late_cb read happen under the lock so the
            # handoff with an interrupted waiter (which checks reply
            # then sets late_cb under the same lock) can't lose the
            # terminal reply to a race.
            with self._lock:
                c.reply = msg
                self._calls.pop(msg.msg_id, None)
                cb = c.late_cb
            c.event.set()
            if cb is not None:
                try:
                    cb(msg)
                except Exception:
                    pass

    @property
    def alive(self) -> bool:
        return self._dead is None and not self._closed

    def _check(self) -> None:
        if self._closed:
            raise GatewayGone("tenant client is closed")
        if self._dead is not None:
            raise GatewayGone(f"gateway connection lost: "
                              f"{self._dead}")

    # ------------------------------------------------------------------

    def request(self, msg_type: str, data=None, *,
                timeout: float | None = 60.0, on_notice=None,
                stamp_epoch: bool = True, late_cb=None) -> Message:
        """One request/response round trip.  ``on_notice`` fires from
        the READER thread for interim ``queued`` frames (queue-
        position backpressure) — keep it cheap and non-blocking.
        ``late_cb(reply)``, when given, fires from the reader thread
        if the waiter abandons the request (KeyboardInterrupt) and the
        terminal reply arrives later on this live connection — without
        it the result would be silently dropped (delivered, so never
        parked gateway-side)."""
        self._check()
        msg = Message(msg_type=msg_type, data=data,
                      rank=self.client_id)
        if stamp_epoch and self.epoch:
            msg.epoch = self.epoch
        call = _Call()
        call.notice_cb = on_notice   # fires from the reader thread
        with self._lock:
            self._calls[msg.msg_id] = call
        try:
            self._ch.send(msg)
        except Exception as e:
            with self._lock:
                self._calls.pop(msg.msg_id, None)
            raise GatewayGone(f"gateway connection lost: {e}") from e
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        try:
            while True:
                step = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                # Notices arrive via the reader thread's notice_cb, so
                # the wait can use long chunks — bounded (not
                # infinite) only so Ctrl-C stays responsive on every
                # platform.
                done = call.event.wait(5.0 if step is None
                                       else min(5.0, step))
                if done:
                    break
                if (deadline is not None
                        and time.monotonic() >= deadline):
                    # Same delivered-or-parked discipline as the
                    # KeyboardInterrupt path below: with a late_cb
                    # the call stays registered so the terminal
                    # reply — which the gateway will count as
                    # DELIVERED and never park — is surfaced instead
                    # of silently dropped.
                    with self._lock:
                        if call.reply is not None:
                            break            # landed at the wire
                        if late_cb is not None:
                            call.late_cb = late_cb
                        else:
                            self._calls.pop(msg.msg_id, None)
                    raise TimeoutError(
                        f"no gateway reply to '{msg_type}' within "
                        f"{timeout}s")
        except KeyboardInterrupt:
            if late_cb is not None:
                with self._lock:
                    landed = call.reply      # set under this lock by
                    if landed is None:       # the reader thread
                        call.late_cb = late_cb   # reader fires later
                if landed is not None:       # landed while unwinding
                    try:
                        late_cb(landed)
                    except Exception:
                        pass
            else:
                with self._lock:
                    self._calls.pop(msg.msg_id, None)
            raise
        if call.reply is None:
            self._check()
            raise GatewayGone("gateway connection lost mid-request")
        if (call.reply.data or {}).get("stale_epoch"):
            # Central fence: EVERY request type surfaces a reattach-
            # elsewhere as TenantFenced (drain()/pool_status() used to
            # swallow it as an empty result).
            raise TenantFenced((call.reply.data or {}).get("error")
                               or "stale tenant epoch")
        return call.reply

    def execute(self, code: str, *, priority: int | None = None,
                deadline_s: float | None = None,
                target_ranks: list[int] | None = None,
                timeout: float | None = None,
                on_queued=None, on_late=None) -> dict:
        """Submit one cell to the pool and wait for its terminal
        verdict.  Returns the gateway reply data
        (``{"status": "ok", "results": {rank: result}}``); raises
        :class:`CellSubmitError` on a shed/rejected verdict.
        ``on_queued(notice)`` fires with the full backpressure notice
        dict — ``position`` plus, under effects admission, the
        ``reason`` naming why the cell was serialized.
        ``on_late(data)`` fires if the waiter is interrupted and the
        cell's result arrives later on this connection.
        ``target_ranks`` narrows the cell to specific pool ranks
        (default: every rank — which fails fast with an error verdict
        when any rank is dead)."""
        payload: dict = {"code": code}
        if priority is not None:
            payload["priority"] = int(priority)
        if deadline_s is not None:
            payload["deadline_s"] = float(deadline_s)
        if target_ranks is not None:
            payload["target_ranks"] = [int(r) for r in target_ranks]

        def _notice(n: dict) -> None:
            if on_queued is not None and n.get("status") == "queued":
                on_queued(dict(n))

        reply = self.request(
            "execute", payload, timeout=timeout, on_notice=_notice,
            late_cb=(None if on_late is None
                     else lambda m: on_late(m.data or {})))
        data = reply.data or {}
        if data.get("status") in ("shed", "rejected"):
            raise CellSubmitError(data)
        return data

    def drain(self, *, timeout: float | None = 60.0,
              on_late=None) -> dict:
        """Claim every result parked for this tenant — exactly once
        (the gateway's claim is destructive; a second drain returns
        an empty dict).  ``on_late({msg_id: reply_data})`` fires from
        the reader thread if the waiter times out or is interrupted
        and the claimed results arrive later — without it a destroyed
        claim whose reply outlived the wait would be lost on both
        sides."""
        reply = self.request(
            "mailbox", {"action": "drain"}, timeout=timeout,
            late_cb=(None if on_late is None
                     else lambda m: on_late(
                         dict((m.data or {}).get("results") or {}))))
        return dict((reply.data or {}).get("results") or {})

    def pool_status(self, *, timeout: float | None = 30.0) -> dict:
        return dict(self.request("pool_status",
                                 timeout=timeout).data or {})

    # ------------------------------------------------------------------
    # serving plane (%dist_serve)

    def serve_start(self, spec: str | None = None, *,
                    tenant: str | None = None,
                    params: str | None = None, cfg: str | None = None,
                    max_batch: int | None = None,
                    max_len: int | None = None,
                    pad_to: int | None = None,
                    eos_id: int | None = None,
                    temperature: float | None = None,
                    steps: int | None = None,
                    queue_depth: int | None = None,
                    inflight: int | None = None,
                    decode_ranks: int | None = None,
                    kv_block_tokens: int | None = None,
                    kv_blocks: int | None = None,
                    prefill_chunk: int | None = None,
                    kv_quantized: bool | None = None,
                    timeout: float | None = 600.0) -> dict:
        """Start the pool's serving plane: run ``spec`` (a cell that
        binds the model params/config in the serving tenant's
        namespace on every rank) and open the decode loop.  Returns
        the serving status dict; raises on an explicit refusal."""
        payload = {k: v for k, v in {
            "spec": spec, "tenant": tenant, "params": params,
            "cfg": cfg, "max_batch": max_batch, "max_len": max_len,
            "pad_to": pad_to, "eos_id": eos_id,
            "temperature": temperature, "steps": steps,
            "queue_depth": queue_depth, "inflight": inflight,
            "decode_ranks": decode_ranks,
            "kv_block_tokens": kv_block_tokens,
            "kv_blocks": kv_blocks, "prefill_chunk": prefill_chunk,
            "kv_quantized": kv_quantized,
        }.items() if v is not None}
        data = dict(self.request("serve_start", payload,
                                 timeout=timeout).data or {})
        if data.get("error"):
            raise RuntimeError(f"serve_start refused: {data['error']}")
        return data

    def serve_submit(self, prompt, max_new_tokens: int, *,
                     priority: int | None = None,
                     timeout: float | None = 60.0) -> dict:
        """Submit one generation request.  Returns the accepted
        verdict (``{"status": "accepted", "rid": ..., "queued": ...}``);
        raises :class:`CellSubmitError` on an explicit shed/rejected
        verdict — the same overload contract cells have."""
        payload: dict = {"prompt": [int(t) for t in prompt],
                         "max_new_tokens": int(max_new_tokens)}
        if priority is not None:
            payload["priority"] = int(priority)
        data = dict(self.request("serve_submit", payload,
                                 timeout=timeout).data or {})
        if data.get("status") in ("shed", "rejected"):
            raise CellSubmitError(data)
        if data.get("error") and data.get("status") != "accepted":
            raise RuntimeError(f"serve_submit failed: {data['error']}")
        return data

    def serve_result(self, rid: str, *,
                     timeout: float | None = 60.0) -> dict:
        """Poll one request: ``{"status", "tokens", "done"}``."""
        return dict(self.request("serve_result", {"rid": rid},
                                 timeout=timeout).data or {})

    def serve_stream(self, rid: str, from_offset: int = 0, *,
                     timeout: float | None = 60.0) -> dict:
        """Claim the stream suffix past ``from_offset`` — the
        reattach-mid-generation resume: pass the last offset this
        client acked and the gateway replays only what is missing
        (live pushes continue via :attr:`on_serve`)."""
        return dict(self.request(
            "serve_stream", {"rid": rid, "from": int(from_offset)},
            timeout=timeout).data or {})

    def serve_status(self, *, timeout: float | None = 30.0) -> dict:
        return dict(self.request("serve_status",
                                 timeout=timeout).data or {})

    def serve_stop(self, *, timeout: float | None = 60.0) -> dict:
        return dict(self.request("serve_stop",
                                 timeout=timeout).data or {})

    def close(self, *, detach: bool = False) -> None:
        if self._closed:
            return
        if detach and self._dead is None:
            try:
                self.request("detach", timeout=5.0)
            except Exception:
                pass
        self._closed = True
        try:
            self._ch.close()
        except Exception:
            pass
        # Closing the channel unblocks the reader loop; reap it so a
        # closed client never leaves a thread that takes self._lock
        # running into interpreter teardown (daemon threads die
        # mid-critical-section there).  close() may be invoked from a
        # reader-thread callback — a thread cannot join itself.
        if threading.current_thread() is not self._reader:
            self._reader.join(timeout=2.0)


# ----------------------------------------------------------------------
# pool admin probes (no tenant slot consumed)


def _admin_request(host: str, port: int, pool_token: str | None,
                   msg_type: str, data=None, *,
                   timeout: float = 30.0) -> dict:
    """One-shot tenant-plane request outside any tenant session —
    the gateway serves ``pool_status``/``pool_shutdown`` pre-hello."""
    cid = secrets.randbelow(1 << 20) + (1 << 30)
    ch = WorkerChannel(host, port, rank=cid, auth_token=pool_token,
                       connect_timeout=timeout)
    try:
        msg = Message(msg_type=msg_type, data=data, rank=cid)
        ch.send(msg)
        deadline = time.monotonic() + timeout
        while True:
            step = max(0.1, deadline - time.monotonic())
            reply = ch.recv(timeout=step)
            if reply.msg_id == msg.msg_id:
                return dict(reply.data or {})
            if time.monotonic() >= deadline:
                raise TimeoutError(f"no {msg_type} reply within "
                                   f"{timeout}s")
    finally:
        try:
            ch.close()
        except (OSError, TransportError):
            pass


def pool_status_probe(host: str, port: int,
                      pool_token: str | None, *,
                      timeout: float = 30.0) -> dict:
    return _admin_request(host, port, pool_token, "pool_status",
                          timeout=timeout)


def pool_shutdown(host: str, port: int, pool_token: str | None, *,
                  timeout: float = 30.0) -> dict:
    return _admin_request(host, port, pool_token, "pool_shutdown",
                          {"token": pool_token}, timeout=timeout)


def pool_resize(host: str, port: int, pool_token: str | None,
                workers: int, *, reason: str = "manual",
                timeout: float = 600.0) -> dict:
    """Resize the pool's worker fleet (drain barrier + epoch bump).
    Long default timeout: the reply lands only after the drain and
    the respawned fleet's readiness."""
    return _admin_request(host, port, pool_token, "pool_resize",
                          {"token": pool_token, "workers": workers,
                           "reason": reason}, timeout=timeout)


def pool_template(host: str, port: int, pool_token: str | None,
                  code: str | None = None, *, name: str = "default",
                  timeout: float = 600.0) -> dict:
    """Register (and run) a warm-start template cell, or list the
    registered templates when ``code`` is None."""
    data = {"token": pool_token, "name": name}
    if code is not None:
        data["code"] = code
    return _admin_request(host, port, pool_token, "pool_template",
                          data, timeout=timeout)


def tenant_export(host: str, port: int, pool_token: str | None,
                  tenant: str, *, timeout: float = 60.0) -> dict:
    """Non-destructive migration snapshot of a tenant's durable
    state (token, epoch, parked results, serve journal)."""
    return _admin_request(host, port, pool_token, "tenant_export",
                          {"token": pool_token, "tenant": tenant},
                          timeout=timeout)


def tenant_import(host: str, port: int, pool_token: str | None,
                  snapshot: dict, *, timeout: float = 60.0) -> dict:
    """Idempotently adopt an exported tenant at this pool."""
    return _admin_request(host, port, pool_token, "tenant_import",
                          {"token": pool_token, "snapshot": snapshot},
                          timeout=timeout)


def tenant_release(host: str, port: int, pool_token: str | None,
                   tenant: str, *, force: bool = False,
                   timeout: float = 60.0) -> dict:
    """Drop a migrated-away tenant from its source pool."""
    return _admin_request(host, port, pool_token, "tenant_release",
                          {"token": pool_token, "tenant": tenant,
                           "force": force}, timeout=timeout)
