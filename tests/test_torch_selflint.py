"""The port's self-lint (``nbdistributed_tpu_torch/analysis/selfcheck.py``,
``concur.py``, ``lifecycle.py``) against the JAX package's.

The synthetic corpora are those of ``tests/unit/test_analysis.py``
(the knob registry, the thread pass, the concurrency corpus from
``_concur_results`` and the lifecycle corpus from
``_lifecycle_results``).  Each corpus module is written into a
throwaway product tree under BOTH package directory names, each
package's passes run over their own tree, and the two must report the
same findings: the same ``(rule, path within the package, line)`` and
the same message.  The JAX test's own expectation on each case is then
held on the port's findings.

Then the port's lint over this checkout: all ten passes clean, its
protocol planes, lock graph and shutdown ledger naming the port's
files, and each of the ten rules firing exactly once on one seeded
defect in a copy of the port's tree.
"""

import ast
import os
import shutil

import pytest

from nbdistributed_tpu.analysis import concur as jax_concur
from nbdistributed_tpu.analysis import lifecycle as jax_lifecycle
from nbdistributed_tpu.analysis import selfcheck as jax_selfcheck
from nbdistributed_tpu_torch.analysis import concur, lifecycle, selfcheck
from nbdistributed_tpu_torch.utils import knobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "nbdistributed_tpu_torch"
TEN = ("env-knobs", "codec-headers", "thread-shared-state",
       "protocol-coverage", "lock-order", "blocking-under-lock",
       "callback-under-lock", "resource-leak", "bracket-discipline",
       "shutdown-completeness")

PACKAGES = {
    "nbdistributed_tpu": (jax_concur, jax_lifecycle),
    PKG: (concur, lifecycle),
}


def _tree(base, pkg, src):
    """A throwaway product tree holding one module, ``pkg/mod.py``."""
    (base / pkg).mkdir(parents=True)
    (base / "tools").mkdir()
    (base / pkg / "mod.py").write_text(src)
    return str(base)


def _key(pkg, f):
    path = f.file[len(pkg) + 1:] if f.file.startswith(pkg + "/") \
        else f.file
    return (f.rule, path, f.line, f.message.replace(pkg + "/", ""))


def _both(tmp_path, src, family):
    """Run ``family`` ("concur" or "lifecycle") over ``src`` under both
    package names; assert they agree; return the port's results."""
    seen = {}
    for pkg, mods in PACKAGES.items():
        mod = mods[0] if family == "concur" else mods[1]
        root = _tree(tmp_path / pkg, pkg, src)
        res = (mod.run_concur_lint(root) if family == "concur"
               else mod.run_lifecycle_lint(root))
        seen[pkg] = (res, {name: sorted(_key(pkg, f) for f in fs)
                           for name, fs in res.items()})
    jax_keys, port_keys = seen["nbdistributed_tpu"][1], seen[PKG][1]
    assert port_keys == jax_keys
    return seen[PKG][0]


def _only(results, rule):
    """Exactly ``rule`` fired (each synthetic violation fires its rule
    and no other)."""
    for name, findings in results.items():
        if name == rule:
            assert findings, f"{rule} did not fire"
        else:
            assert findings == [], (
                f"[{name}] " + "; ".join(f.render() for f in findings))
    return results[rule]


def _clean(results):
    assert all(v == [] for v in results.values()), {
        k: [f.render() for f in v] for k, v in results.items() if v}


# ----------------------------------------------------------------------
# the knob registry and the env-knob pass


def test_undeclared_knob_read_fails_fast():
    with pytest.raises(KeyError, match="NBD_TOTALLY_BOGUS"):
        knobs.get_raw("NBD_TOTALLY_BOGUS")


def test_knob_accessor_semantics():
    env = {"NBD_HANG": "off", "NBD_HANG_SKEW_S": "2.5",
           "NBD_FLIGHT_RING_BYTES": "1024",
           "NBD_ORPHAN_TTL_S": "soon"}
    assert knobs.get_bool("NBD_HANG", True, env=env) is False
    assert knobs.get_bool("NBD_FLIGHT", True, env=env) is True
    assert knobs.get_float("NBD_HANG_SKEW_S", 20.0, env=env) == 2.5
    assert knobs.get_int("NBD_FLIGHT_RING_BYTES", 0, env=env) == 1024
    # Typo'd numeric knobs degrade to the default, never crash.
    assert knobs.get_float("NBD_ORPHAN_TTL_S", 600.0, env=env) == 600.0
    assert knobs.get_str("NBD_RUN_DIR", "-", env=env) == "-"


def test_knob_table_documents_every_knob():
    table = knobs.knob_table_markdown()
    for name in knobs.KNOBS:
        assert f"`{name}`" in table


@pytest.mark.parametrize("pkg,mod", [
    ("nbdistributed_tpu", jax_selfcheck), (PKG, selfcheck)])
def test_env_knob_pass_catches_undeclared_knob(tmp_path, pkg, mod):
    root = _tree(tmp_path, pkg,
                 "import os\nX = os.environ.get('NBD_BOGUS_KNOB')\n")
    findings = [f for f in mod.check_env_knobs(root)
                if f.file != "README.md"]
    assert [(f.rule, f.file, f.line) for f in findings] == [
        ("env-knob", f"{pkg}/mod.py", 2)]
    assert "NBD_BOGUS_KNOB" in findings[0].message


def test_env_knob_pass_reads_the_port_tools_and_the_chip_script(tmp_path):
    """The port's product tree is its package, ``tools/nbd_torch_*.py``
    and ``chip_smoke.py``: the JAX package's other tools are not
    scanned."""
    root = _tree(tmp_path, PKG, "X = 1\n")
    (tmp_path / "tools" / "nbd_torch_x.py").write_text("A = 'NBD_BOGUS_A'\n")
    (tmp_path / "tools" / "nbd_x.py").write_text("B = 'NBD_BOGUS_B'\n")
    (tmp_path / "chip_smoke.py").write_text("C = 'NBD_BOGUS_C'\n")
    (tmp_path / "bench.py").write_text("D = 'NBD_BOGUS_D'\n")
    found = sorted((f.file, f.line) for f in selfcheck.check_env_knobs(root)
                   if f.file != "README.md")
    assert found == [("chip_smoke.py", 1), ("tools/nbd_torch_x.py", 1)]


# ----------------------------------------------------------------------
# the thread pass (pure AST: the same visitor in both packages)


_THREAD_SRC = """
class C:
    def __init__(self):
        self._lock = None
        self.counts = dict()
    def bump(self):
        <BODY>
"""

_LOCKED_SRC = """
class C:
    def __init__(self):
        self._lock = None
        self.counts = dict()
    def _bump_locked(self):
        self.counts['a'] = 1
        self.n += 1
    def unlocked_caller(self):
        self._bump_locked()
    def locked_caller(self):
        with self._lock:
            self._bump_locked()
"""


def _thread_findings(mod, src, method=None, exempt=None):
    tree = ast.parse(src)
    cls = tree.body[0]
    fn = [n for n in cls.body if isinstance(n, ast.FunctionDef)
          and n.name != "__init__"
          and (method is None or n.name == method)][0]
    p = mod._ThreadPass("x.py", cls.name, {"counts"}, exempt or {},
                        method=fn.name)
    p.visit(fn)
    return [(f.rule, f.line, f.message) for f in p.findings]


@pytest.mark.parametrize("src,method,exempt,fires", [
    (_THREAD_SRC.replace("<BODY>", "self.counts['a'] = 1"), None, None,
     True),
    (_THREAD_SRC.replace("<BODY>", "self.n += 1"), None, None, True),
    (_THREAD_SRC.replace(
        "<BODY>", "with self._lock:\n            self.counts['a'] = 1"),
     None, None, False),
    (_THREAD_SRC.replace("<BODY>", "self.n += 1"), None,
     {"C.n": "single writer"}, False),
    (_LOCKED_SRC, "_bump_locked", None, False),
    (_LOCKED_SRC, "unlocked_caller", None, True),
    (_LOCKED_SRC, "locked_caller", None, False),
], ids=["item-write", "augassign", "locked", "exempt", "locked-suffix",
        "unlocked-call-to-locked", "locked-call-to-locked"])
def test_thread_pass_cases(src, method, exempt, fires):
    port = _thread_findings(selfcheck, src, method, exempt)
    assert port == _thread_findings(jax_selfcheck, src, method, exempt)
    assert bool(port) == fires
    if method == "unlocked_caller":
        assert "lock-asserting" in port[0][2]


def test_thread_pass_covers_the_ports_gateway_files():
    covered = {os.path.basename(f) for f in selfcheck._THREAD_CHECKED_FILES}
    jax_covered = {os.path.basename(f)
                   for f in jax_selfcheck._THREAD_CHECKED_FILES}
    assert {"daemon.py", "tenancy.py", "scheduler.py"} <= covered
    assert covered == jax_covered
    for rel in selfcheck._THREAD_CHECKED_FILES:
        assert os.path.isfile(selfcheck._pkg_path(REPO, rel)), rel


# ----------------------------------------------------------------------
# the concurrency corpus (``_concur_results`` in the JAX tests)


_CYCLE_SRC = """
import threading

class A:
    def __init__(self):
        self._lock = threading.Lock()
        self._other_lock = threading.Lock()
    def fwd(self):
        with self._lock:
            with self._other_lock:
                pass
    def rev(self):
        with self._other_lock:
            with self._lock:
                pass
"""

_BURIED_CYCLE_SRC = """
import threading

class A:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()
        self._c_lock = threading.Lock()
    def ab(self):
        with self._a_lock:
            with self._b_lock:
                pass
    def ac(self):
        with self._a_lock:
            with self._c_lock:
                pass
    def fwd(self):
        with self._b_lock:
            with self._c_lock:
                pass
    def rev(self):
        with self._c_lock:
            with self._b_lock:
                pass
"""

_REACQUIRE_SRC = """
import threading

class B:
    def __init__(self):
        self._lock = threading.{LOCK}()
    def outer(self):
        with self._lock:
            self._inner()
    def _inner(self):
        with self._lock:
            pass
"""

_SENDALL_SRC = """
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.sock = None
    def flush(self, frame):
        with self._lock:
            self.sock.sendall(frame)
"""

_CALLBACK_SRC = """
import threading

class D:
    def __init__(self):
        self._lock = threading.Lock()
        self.on_done = None
    def fire_direct(self):
        with self._lock:
            self.on_done(1)
    def fire_alias(self):
        with self._lock:
            cb = self.on_done
            cb(2)
    def fire_outside(self):
        with self._lock:
            cb = self.on_done
        cb(3)
"""

_LOCKED_HELPER_SRC = """
import threading
import time

class E:
    def __init__(self):
        self._lock = threading.Lock()
    def _flush_locked(self):
        time.sleep(1)
"""

_VIA_HELPER_SRC = """
import threading

class F:
    def __init__(self):
        self._lock = threading.Lock()
        self.ch = None
    def caller(self):
        with self._lock:
            self._emit()
    def _emit(self):
        self.ch.sendall(b"x")
"""

_ACQUIRE_RELEASE_SRC = """
import threading
import time

class G:
    def __init__(self):
        self._lock = threading.Lock()
    def run(self):
        self._lock.acquire()
        time.sleep(1)
        self._lock.release()
        time.sleep(2)
"""

_MODULE_LOCK_SRC = """
import threading
import time

_lock = threading.Lock()

def flush():
    with _lock:
        time.sleep(1)
"""

_NON_LOCK_SRC = """
import time

class H:
    def __init__(self):
        self.blocker = object()
    def run(self):
        with self.blocker:
            time.sleep(1)
"""


def _line_of(src, text):
    return src.splitlines().index(text) + 1


def _expect_cycle(found):
    assert any("cycle" in f.message and "A._lock" in f.message
               and "A._other_lock" in f.message for f in found)


def _expect_buried(found):
    assert any("cycle" in f.message and "A._b_lock" in f.message
               and "A._c_lock" in f.message for f in found)
    assert all("A._a_lock" not in f.message for f in found)


def _expect_callbacks(found):
    # Direct invocation and the locked alias fire; the copy-then-
    # invoke-outside pattern (the documented fix) is clean.
    assert len(found) == 2
    src_lines = _CALLBACK_SRC.splitlines()
    assert all("fire_outside" not in src_lines[f.line - 2] for f in found)


CONCUR_CASES = {
    "lock-order-cycle": (_CYCLE_SRC, "lock-order", _expect_cycle),
    "lock-order-buried-cycle": (_BURIED_CYCLE_SRC, "lock-order",
                                _expect_buried),
    "plain-lock-reacquire": (
        _REACQUIRE_SRC.replace("{LOCK}", "Lock"), "lock-order",
        lambda found: any("already held" in f.message for f in found)),
    "rlock-reacquire-clean": (_REACQUIRE_SRC.replace("{LOCK}", "RLock"),
                              None, None),
    "sendall-under-lock": (
        _SENDALL_SRC, "blocking-under-lock",
        lambda found: "sendall" in found[0].message
        and "C._lock" in found[0].message),
    "blocking-ok-exemption": (
        '_LINT_BLOCKING_OK = {"C.flush:sendall": "frame-write '
        'serializer"}\n' + _SENDALL_SRC, None, None),
    "callback-under-lock": (_CALLBACK_SRC, "callback-under-lock",
                            _expect_callbacks),
    "callback-ok-exemption": (
        '_LINT_CALLBACK_OK = {"D.fire_direct:on_done": "reentry-safe by '
        'contract", "D.fire_alias:cb": "ditto"}\n' + _CALLBACK_SRC,
        None, None),
    "locked-suffix-entry-lockset": (
        _LOCKED_HELPER_SRC, "blocking-under-lock",
        lambda found: "time.sleep" in found[0].message
        and "E._lock" in found[0].message),
    "locked-helper-reported-once": (
        _LOCKED_HELPER_SRC + """
    def caller_one(self):
        with self._lock:
            self._flush_locked()
    def caller_two(self):
        with self._lock:
            self._flush_locked()
""", "blocking-under-lock",
        lambda found: len(found) == 1
        and found[0].message.startswith("E._flush_locked:")),
    "one-level-via-helper": (
        _VIA_HELPER_SRC, "blocking-under-lock",
        lambda found: "via F._emit" in found[0].message
        and found[0].line == _line_of(_VIA_HELPER_SRC,
                                      "            self._emit()")),
    "acquire-release-pairs": (
        _ACQUIRE_RELEASE_SRC, "blocking-under-lock",
        lambda found: len(found) == 1 and found[0].line == _line_of(
            _ACQUIRE_RELEASE_SRC, "        time.sleep(1)")),
    "module-level-lock": (
        _MODULE_LOCK_SRC, "blocking-under-lock",
        lambda found: "mod::_lock" in found[0].message),
    "non-lock-attrs-never-participate": (_NON_LOCK_SRC, None, None),
}


@pytest.mark.parametrize("case", sorted(CONCUR_CASES))
def test_concur_corpus_matches_the_jax_package(tmp_path, case):
    src, rule, expect = CONCUR_CASES[case]
    res = _both(tmp_path, src, "concur")
    if rule is None:
        _clean(res)
        return
    found = _only(res, rule)
    if expect is not None:
        assert expect(found) is not False, [f.render() for f in found]


# ----------------------------------------------------------------------
# the lifecycle corpus (``_lifecycle_results`` in the JAX tests)


_SERVE_BRACKET_HEAD = """
import threading

class G:
    def __init__(self):
        self._lock = threading.Lock()
        self._serving = {}
    def _serve_done(self, name):
        with self._lock:
            self._serving[name] = self._serving.get(name, 1) - 1
"""

LIFECYCLE_CASES = {
    "leak-socket-never-released": ("""
import socket

def probe(host):
    s = socket.create_connection((host, 80))
    s.sendall(b"x")
""", "resource-leak", lambda found: "never released" in found[0].message
        and "socket" in found[0].message),
    "leak-release-only-on-fall-through": ("""
import socket

def probe(host):
    s = socket.create_connection((host, 80))
    s.sendall(b"x")
    s.close()
""", "resource-leak", lambda found: "fall-through" in found[0].message),
    "leak-clean-with-block-and-finally": ("""
import socket

def probe_with(host):
    with socket.create_connection((host, 80)) as s:
        s.sendall(b"x")

def probe_finally(host):
    s = socket.create_connection((host, 80))
    try:
        s.sendall(b"x")
    finally:
        s.close()

def make_and_close():
    s = socket.socket()
    s.close()
""", None, None),
    "leak-ownership-transfer-clean": ("""
import socket

def returned():
    s = socket.socket()
    return s

def registered(registry):
    s = socket.socket()
    registry.register(s)

class Owner:
    def __init__(self):
        self.sock = None
    def arm(self, host):
        s = socket.create_connection((host, 80))
        self.sock = s
    def close(self):
        self.sock.close()
""", None, None),
    "leak-nondaemon-thread": ("""
import threading

def run(fn):
    t = threading.Thread(target=fn)
    t.start()
""", "resource-leak", lambda found: "thread" in found[0].message),
    "leak-daemon-or-joined-thread-clean": ("""
import threading

def run(fn):
    t = threading.Thread(target=fn, daemon=True)
    t.start()

def run_joined(fn):
    t = threading.Thread(target=fn)
    t.start()
    try:
        pass
    finally:
        t.join()
""", None, None),
    "leak-popen": ("""
import subprocess

def launch(argv):
    p = subprocess.Popen(argv)
    p.poll()
""", "resource-leak", lambda found: "process" in found[0].message),
    "leak-popen-waited-and-read-open-clean": ("""
import subprocess

def launch(argv):
    p = subprocess.Popen(argv)
    p.wait()

def read(path):
    f = open(path)
    return f
""", None, None),
    "leak-socketpair-each-end": ("""
import socket

def pair():
    r, w = socket.socketpair()
    r.close()
""", "resource-leak", lambda found: len(found) == 1
        and "'w'" in found[0].message),
    "leak-socketpair-both-closed-clean": ("""
import socket

def pair():
    r, w = socket.socketpair()
    try:
        pass
    finally:
        r.close()
        w.close()
""", None, None),
    "leak-exemption": ("""
_LINT_LIFECYCLE_OK = {"probe:socket": "one-shot probe; the process "
                      "exits right after and the OS reclaims the fd"}
import socket

def probe(host):
    s = socket.create_connection((host, 80))
    s.sendall(b"x")
""", None, None),
    "bracket-serve-slot-unprotected": (_SERVE_BRACKET_HEAD + """
    def submit(self, name):
        with self._lock:
            self._serving[name] = self._serving.get(name, 0) + 1
        self.do_work(name)
""", "bracket-discipline", lambda found: "serve-slot" in found[0].message),
    "bracket-serve-slot-handoff-clean": (_SERVE_BRACKET_HEAD + """
    def submit(self, name):
        with self._lock:
            self._serving[name] = self._serving.get(name, 0) + 1
        threading.Thread(target=self._serve, args=(name,),
                         daemon=True).start()
    def _serve(self, name):
        try:
            self.work(name)
        finally:
            self._serve_done(name)
    def submit_inline(self, name):
        with self._lock:
            self._serving[name] = self._serving.get(name, 0) + 1
        try:
            self.work(name)
        finally:
            self._serve_done(name)
""", None, None),
    "bracket-mailbox-claim": ("""
class W:
    def drain(self, box, reply):
        claimed = box.claim_all()
        return reply(claimed)
""", "bracket-discipline", lambda found: "mailbox-claim"
        in found[0].message),
    "bracket-mailbox-repark-clean": ("""
class W:
    def drain(self, box, reply):
        claimed = box.claim_all()
        try:
            return reply(claimed)
        except Exception:
            for mid, r in claimed.items():
                box.park(mid, r)
            raise
""", None, None),
    "bracket-gauge-updown": ("""
class M:
    def __init__(self):
        self.g = None
    def enter(self):
        self.g.inc()
        self.work()
    def leave(self):
        self.g.dec()
""", "bracket-discipline", lambda found: "gauge-updown"
        in found[0].message),
    "bracket-gauge-monotonic-clean": ("""
class M:
    def count(self, c):
        c.inc()
        self.work()
""", None, None),
    "bracket-gauge-other-receiver-clean": ("""
class M:
    def __init__(self):
        self.g = None
        self.requests = None
    def count(self):
        self.requests.inc()
        self.work()
    def leave(self):
        self.g.dec()
""", None, None),
    "bracket-gauge-finally-clean": ("""
class M:
    def __init__(self):
        self.g = None
    def enter(self):
        self.g.inc()
        try:
            self.work()
        finally:
            self.g.dec()
""", None, None),
    "bracket-exemption": ("""
_LINT_LIFECYCLE_OK = {"W.drain:mailbox-claim": "the completion "
                      "callback reparks on failure by contract"}

class W:
    def drain(self, box, reply):
        claimed = box.claim_all()
        return reply(claimed)
""", None, None),
    "shutdown-unreleased-socket": ("""
import socket

class S:
    def __init__(self):
        self._sock = socket.create_connection(("h", 1))
    def close(self):
        pass
""", "shutdown-completeness", lambda found: "_sock" in found[0].message),
    "shutdown-released-socket-clean": ("""
import socket

class S:
    def __init__(self):
        self._sock = socket.create_connection(("h", 1))
    def close(self):
        self._sock.close()
""", None, None),
    "shutdown-no-surface": ("""
import socket

class S:
    def __init__(self):
        self._sock = socket.socket()
""", "shutdown-completeness", lambda found: "defines no close"
        in found[0].message),
    "shutdown-nondaemon-thread-unjoined": ("""
import threading

class S:
    def __init__(self):
        self._t = threading.Thread(target=self._run)
        self._t.start()
    def _run(self):
        pass
    def close(self):
        pass
""", "shutdown-completeness", lambda found: "non-daemon thread"
        in found[0].message),
    "shutdown-daemon-thread-lock-hazard": ("""
import threading

class S:
    def __init__(self):
        self._lock = threading.Lock()
        self._t = threading.Thread(target=self._run, daemon=True)
    def _run(self):
        with self._lock:
            pass
    def close(self):
        pass
""", "shutdown-completeness", lambda found: "interpreter teardown"
        in found[0].message),
    "shutdown-daemon-thread-joined-clean": ("""
import threading

class S:
    def __init__(self):
        self._lock = threading.Lock()
        self._t = threading.Thread(target=self._run, daemon=True)
    def _run(self):
        with self._lock:
            pass
    def close(self):
        self._t.join(timeout=1.0)
""", None, None),
    "shutdown-daemon-thread-harmless-clean": ("""
import threading

class S:
    def __init__(self):
        self._t = threading.Thread(target=self._run, daemon=True)
    def _run(self):
        pass
""", None, None),
    "shutdown-owner-typed-attr": ("""
import socket

class Inner:
    def __init__(self):
        self._sock = socket.socket()
    def close(self):
        self._sock.close()

class Outer:
    def __init__(self):
        self._inner = Inner()
    def close(self):
        pass
""", "shutdown-completeness", lambda found: "Inner" in found[0].message
        and "_inner" in found[0].message),
    "shutdown-alias-release-clean": ("""
import socket

class S:
    def __init__(self):
        self._sock = socket.socket()
        self._wake_r, self._wake_w = socket.socketpair()
    def close(self):
        s, self._sock = self._sock, None
        s.close()
        for w in (self._wake_r, self._wake_w):
            w.close()
""", None, None),
    "shutdown-exemption": ("""
_LINT_LIFECYCLE_OK = {"S:_sock": "held for the process lifetime by "
                      "design (faulthandler-style registration)"}
import socket

class S:
    def __init__(self):
        self._sock = socket.socket()
""", None, None),
}


@pytest.mark.parametrize("case", sorted(LIFECYCLE_CASES))
def test_lifecycle_corpus_matches_the_jax_package(tmp_path, case):
    src, rule, expect = LIFECYCLE_CASES[case]
    res = _both(tmp_path, src, "lifecycle")
    if rule is None:
        _clean(res)
        return
    found = _only(res, rule)
    if expect is not None:
        assert expect(found), [f.render() for f in found]


# ----------------------------------------------------------------------
# protocol coverage


@pytest.mark.parametrize("mod", [jax_selfcheck, selfcheck],
                         ids=["jax", "torch"])
def test_protocol_coverage_synthetic_both_directions(mod):
    planes = [{"name": "x",
               "sent": {"a": ("f.py", 1), "b": ("f.py", 2)},
               "handled": {"a": ("g.py", 3), "c": ("g.py", 4)}}]
    found = mod.check_protocol_coverage(REPO, planes=planes, external={})
    msgs = [f.message for f in found]
    assert len(found) == 2
    assert any("'b' is sent here but no receiver handles" in m
               for m in msgs)
    assert any("'c' is registered here but nothing" in m for m in msgs)
    assert mod.check_protocol_coverage(
        REPO, planes=planes, external={"x:b": "why", "x:c": "why"}) == []


def test_protocol_planes_cover_the_ports_wire():
    planes = {p["name"]: p for p in selfcheck._protocol_planes(REPO)}
    assert set(planes) == {"worker", "worker-notice", "tenant",
                           "tenant-notice", "agent", "agent-notice"}
    for p in planes.values():
        for rel, _ in list(p["sent"].values()) + list(p["handled"].values()):
            assert rel.startswith(PKG + "/"), rel
    assert {"execute", "shutdown", "tenant_gc"} <= set(
        planes["worker"]["sent"])
    assert {"execute", "shutdown", "tenant_gc", "serve_open",
            "serve_step", "serve_close"} <= set(planes["worker"]["handled"])
    assert {"tenant_hello", "execute", "mailbox", "detach", "serve_submit",
            "serve_result", "serve_stream", "serve_start", "serve_status",
            "serve_stop"} <= set(planes["tenant"]["sent"])
    assert {"queued", "parked_notice", "stream_output", "serve_tokens",
            "serve_done", "response"} == set(
        planes["tenant-notice"]["sent"])
    assert {"spawn", "signal", "tail", "reap", "poll"} <= set(
        planes["agent"]["sent"])


def test_wire_extensions_registry_shape():
    from nbdistributed_tpu_torch.messaging.codec import (BASE_HEADER_KEYS,
                                                         WIRE_EXTENSIONS)
    assert {"at", "tr", "ep"} <= {
        k for k, v in WIRE_EXTENSIONS.items() if v["plane"] == "header"}
    assert {"col", "busy_s", "tel"} <= {
        k for k, v in WIRE_EXTENSIONS.items() if v["plane"] == "ping"}
    assert not set(WIRE_EXTENSIONS) & set(BASE_HEADER_KEYS)


# ----------------------------------------------------------------------
# the port's lint over this checkout


@pytest.fixture(scope="module")
def checkout_results():
    return selfcheck.run_self_lint(REPO)


def test_self_lint_clean_on_this_checkout(checkout_results):
    assert tuple(checkout_results) == TEN
    for name, findings in checkout_results.items():
        assert findings == [], (
            f"[{name}] " + "; ".join(f.render() for f in findings))


def test_exemption_tables_carry_the_jax_packages_sites():
    """The port's tables hold the JAX package's keys and reasons, site
    for site, in the port's copies of the same modules."""
    for rel, names in (("gateway/daemon.py", ("_LINT_BLOCKING_OK",
                                              "_LINT_CALLBACK_OK")),
                       ("messaging/pipeline.py", ("_LINT_BLOCKING_OK",
                                                  "_LINT_LIFECYCLE_OK"))):
        trees = [ast.parse(open(os.path.join(REPO, pkg, rel)).read())
                 for pkg in ("nbdistributed_tpu", PKG)]
        for name in names:
            jax_t, port_t = (concur._str_table(t, name) for t in trees)
            assert jax_t and port_t == jax_t, (rel, name)


def test_lock_graph_names_the_ports_locks():
    dot = concur.lock_graph_dot(REPO)
    assert dot.startswith("digraph lock_order")
    assert '"GatewayDaemon._lock" -> "ResultMailbox._mlock"' in dot
    assert "style=dashed" in dot
    assert f'label="{PKG}/gateway/daemon.py:' in dot


def test_shutdown_ledger_report_shape():
    import json
    ledger = lifecycle.shutdown_ledger(REPO)
    tc = ledger["TenantClient"]
    assert tc["file"] == f"{PKG}/gateway/client.py"
    reader = {r["attr"]: r for r in tc["resources"]}["_reader"]
    assert reader["daemon"] and "join" in reader["released_by"]
    w = ledger["DistributedWorker"]
    stack = {r["attr"]: r for r in w["resources"]}["_stack_file"]
    assert stack["exempt"] and "faulthandler" in stack["exempt"]
    json.dumps(ledger)


# ----------------------------------------------------------------------
# each rule fires exactly once on one seeded defect in a copy of the
# port's tree


SEEDED = {
    "env-knobs": ("seeded_knob.py", 2, """\
import os
X = os.environ.get("NBD_SEEDED_BOGUS")
"""),
    "protocol-coverage": ("seeded_protocol.py", 2, """\
def poke(comm):
    comm.send_to_ranks([0], "seeded_unhandled_type")
"""),
    "lock-order": ("seeded_lock_order.py", 9, _CYCLE_SRC.replace(
        "class A:", "class SeededA:").lstrip("\n")),
    "blocking-under-lock": ("seeded_blocking.py", 9, _SENDALL_SRC.replace(
        "class C:", "class SeededC:").lstrip("\n")),
    "callback-under-lock": ("seeded_callback.py", 9, """\
import threading

class SeededD:
    def __init__(self):
        self._lock = threading.Lock()
        self.on_done = None
    def fire_direct(self):
        with self._lock:
            self.on_done(1)
"""),
    "resource-leak": ("seeded_leak.py", 4, """\
import socket

def seeded_probe(host):
    s = socket.create_connection((host, 80))
    s.sendall(b"x")
"""),
    "bracket-discipline": ("seeded_bracket.py", 3, """\
class SeededW:
    def drain(self, box, reply):
        claimed = box.claim_all()
        return reply(claimed)
"""),
    "shutdown-completeness": ("seeded_shutdown.py", 3, """\
import socket

class SeededS:
    def __init__(self):
        self._sock = socket.socket()
"""),
}

_THREAD_SEED = """

class SeededT:
    def __init__(self):
        self._lock = threading.Lock()
        self.counts = {}
    def bump(self):
        self.counts["a"] = 1
"""


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """A copy of the port's product tree (the package, its tools, the
    chip script, the README) with one defect for each of the ten rules,
    and the ten passes' findings over it."""
    root = tmp_path_factory.mktemp("seeded")
    shutil.copytree(os.path.join(REPO, PKG), root / PKG,
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    (root / "tools").mkdir()
    for name in os.listdir(os.path.join(REPO, "tools")):
        if name.startswith("nbd_torch_") and name.endswith(".py"):
            shutil.copy(os.path.join(REPO, "tools", name), root / "tools")
    for name in ("chip_smoke.py", "README.md"):
        shutil.copy(os.path.join(REPO, name), root / name)
    where = {}
    for rule, (name, line, src) in SEEDED.items():
        (root / PKG / name).write_text(src)
        where[rule] = (f"{PKG}/{name}", line)
    # codec-headers: the heartbeat piggybacks an undeclared ping field.
    worker = root / PKG / "runtime" / "worker.py"
    text = worker.read_text()
    hb = next(n for n in ast.walk(ast.parse(text))
              if isinstance(n, ast.FunctionDef) and n.name == "_heartbeat")
    body = hb.body[0]
    lines = text.splitlines(keepends=True)
    lines.insert(body.lineno - 1, " " * body.col_offset
                 + 'data["seeded_field"] = 0\n')
    worker.write_text("".join(lines))
    where["codec-headers"] = (f"{PKG}/runtime/worker.py", hb.lineno)
    # thread-shared-state: an unlocked container write in a checked file.
    auto = root / PKG / "resilience" / "autoscaler.py"
    text = auto.read_text()
    if "import threading" not in text:
        text = "import threading\n" + text
    auto.write_text(text + _THREAD_SEED)
    where["thread-shared-state"] = (
        f"{PKG}/resilience/autoscaler.py",
        len(auto.read_text().splitlines()))
    return selfcheck.run_self_lint(str(root)), where


@pytest.mark.parametrize("rule", TEN)
def test_each_rule_fires_once_on_its_seeded_defect(seeded, rule):
    results, where = seeded
    assert tuple(results) == TEN
    assert sum(len(v) for v in results.values()) == len(TEN), {
        k: [f.render() for f in v] for k, v in results.items() if v}
    (finding,) = results[rule]
    assert (finding.file, finding.line) == where[rule], finding.render()
