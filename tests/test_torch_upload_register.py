"""Registration of recurring caller-owned host memory in
``serve/tick.py::upload`` (:class:`~foveax_torch.serve.tick.HostRegistry`),
on the CPU against a fake runtime and a fake CUDA target: an owner is
registered on its second sighting and never again, a caller that hands
fresh arrays registers nothing, views of one owner register the owner's
whole range once, the range is unregistered as the owner dies, a refused
registration is not retried, and every other input is copied as before.
The span attributes ``registered`` and ``register``, the counter
``<span>_registered`` and the readers ``tick.stage_registered_share`` and
``restore.upload_registered_share``.  The card's half is in
``tests/test_torch_readback.py``."""

import gc
import sys
import threading
import time

import numpy as np
import pytest
import torch

from benchmark.trace import Trace, load_module
from foveax_torch.config import FoveaxConfig
from foveax_torch.pipeline import profiling
from foveax_torch.pipeline.frames import FoveationPipeline
from foveax_torch.serve import tick as tick_mod
from foveax_torch.serve.client import ClientRestore
from foveax_torch.serve.tick import CudaHostRuntime, HostRegistry, ServeTick, upload

CPU = torch.device("cpu")
SMALL = dict(source_width=96, source_height=64, reduced_width=48, reduced_height=32)


class FakeRuntime:
    """CUDA's host registrations as a table: a range that overlaps one
    registered already is refused, as ``cudaHostRegister`` refuses it."""

    def __init__(self, refuse: bool = False, delay: float = 0.0):
        self.refuse = refuse
        self.delay = delay  # s a registration takes, the interpreter lock released
        self.ranges: dict[int, int] = {}
        self.registers: list[tuple[int, int]] = []
        self.unregisters: list[int] = []

    def register(self, ptr, nbytes):
        self.registers.append((ptr, nbytes))
        time.sleep(self.delay)
        if self.refuse or any(ptr < p + n and p < ptr + nbytes for p, n in self.ranges.items()):
            return False
        self.ranges[ptr] = nbytes
        return True

    def unregister(self, ptr):
        self.unregisters.append(ptr)
        del self.ranges[ptr]


@pytest.fixture()
def fake(monkeypatch):
    """A registry over a fake runtime whose target is the CPU device, in
    the place of the process's."""
    profiling.clear()
    reg = HostRegistry(FakeRuntime(), target="cpu")
    monkeypatch.setattr(tick_mod, "HOSTS", reg)
    yield reg
    profiling.clear()


def _stage(x, name="serve.stage"):
    """``x`` uploaded in a counted span ``name``; the copy and the span."""
    got = upload(x, CPU, profiling.span(name), counted=True)
    return got, profiling.spans(names=(name,))[-1]


def _pool(kind: str, n: int = 4, shape=(6, 5, 3)):
    """``n`` frames as views of one owner, as a decoder's pool: an
    ndarray's rows, or the rows of a CPU tensor's ``.numpy()`` view (as
    ``benchmark/inputs.py::frame_pool`` makes them)."""
    rng = np.random.default_rng(7)
    if kind == "ndarray":
        host = rng.integers(0, 256, (n, *shape), dtype=np.uint8)
    else:
        host = torch.from_numpy(rng.integers(0, 256, (n, *shape), dtype=np.uint8)).clone().numpy()
    return [np.ascontiguousarray(host[i]) for i in range(n)]


def _owner_range(view):
    owner = tick_mod._owner(view)
    return tick_mod._extent(owner)


@pytest.mark.parametrize("kind", ["ndarray", "tensor"])
def test_second_sighting_registers_once(fake, kind):
    (frame,) = _pool(kind, n=1)
    before = profiling.counts().get("serve.stage_registered", 0)
    attrs = []
    for _ in range(4):
        got, rec = _stage(frame)
        assert got.numpy().tobytes() == frame.tobytes()
        attrs.append(rec.attrs)
    b = frame.nbytes
    assert attrs == [{"registered": False, "bytes": b},
                     {"registered": True, "register": True, "bytes": b},
                     {"registered": True, "bytes": b}, {"registered": True, "bytes": b}]
    assert fake.runtime.registers == [_owner_range(frame)]
    assert profiling.counts().get("serve.stage_registered", 0) - before == 3


def test_fresh_arrays_register_nothing(fake):
    rng = np.random.default_rng(3)
    for _ in range(20):
        frame = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
        got, rec = _stage(frame)
        assert rec.attrs == {"registered": False, "bytes": frame.nbytes}
    del frame, got  # on the CPU the copy is the array itself
    gc.collect()
    assert fake.runtime.registers == [] and fake.runtime.ranges == {}
    assert len(fake) == 0


@pytest.mark.parametrize("kind", ["ndarray", "tensor"])
def test_views_of_one_owner_register_its_whole_range_once(fake, kind):
    pool = _pool(kind)
    for k in range(12):
        _, rec = _stage(pool[k % 4])
        assert rec.attrs["registered"] == (k >= 1)
    ptr, nbytes = _owner_range(pool[0])
    assert fake.runtime.registers == [(ptr, nbytes)]
    assert nbytes == 4 * pool[0].nbytes
    assert ptr <= pool[3].ctypes.data and pool[3].ctypes.data + pool[3].nbytes <= ptr + nbytes
    assert len(fake) == 1


@pytest.mark.parametrize("kind", ["ndarray", "tensor"])
def test_owner_death_unregisters_once(fake, kind):
    pool = _pool(kind)
    for f in pool[:3]:
        _stage(f)
    ptr, _ = _owner_range(pool[0])
    assert fake.runtime.ranges == {ptr: 4 * pool[0].nbytes}
    del f
    pool.pop()
    gc.collect()
    assert fake.runtime.unregisters == []  # a view still holds the owner
    del pool
    gc.collect()
    assert fake.runtime.unregisters == [ptr]
    assert fake.runtime.ranges == {} and len(fake) == 0


def test_refused_registration_is_not_retried(monkeypatch):
    profiling.clear()
    reg = HostRegistry(FakeRuntime(refuse=True), target="cpu")
    monkeypatch.setattr(tick_mod, "HOSTS", reg)
    (frame,) = _pool("ndarray", n=1)
    for _ in range(5):
        got, rec = _stage(frame)
        assert rec.attrs == {"registered": False, "bytes": frame.nbytes}
        assert got.numpy().tobytes() == frame.tobytes()
    assert len(reg.runtime.registers) == 1
    assert "serve.stage_registered" not in profiling.counts()


def test_overlapping_owners_fall_back(fake):
    """Two owners over one block (two tensors' ``.numpy()`` views of one
    storage): the first registers the storage, the second is refused and
    copied as before."""
    t = torch.from_numpy(np.arange(600, dtype=np.uint8))
    a, b = t.numpy(), t.numpy()
    assert tick_mod._owner(a) is not tick_mod._owner(b)
    for _ in range(2):
        _stage(a)
    for _ in range(3):
        _, rec = _stage(b)
    assert rec.attrs["registered"] is False
    assert len(fake.runtime.registers) == 2 and len(fake.runtime.ranges) == 1


def _memmap(tmp_path):
    m = np.memmap(tmp_path / "frame.bin", dtype=np.uint8, mode="w+", shape=(6, 5, 3))
    m[:] = np.arange(90, dtype=np.uint8).reshape(6, 5, 3)
    return m


def _read_only():
    a = np.arange(90, dtype=np.uint8).reshape(6, 5, 3)
    a.setflags(write=False)
    return a


@pytest.mark.filterwarnings("ignore:The given NumPy array is not writable")
@pytest.mark.parametrize("case", ["non_contiguous", "read_only", "memmap", "memmap_view", "tensor",
                                  "list"])
def test_other_inputs_take_todays_path(fake, case, tmp_path):
    x = {"non_contiguous": lambda: np.arange(180, dtype=np.uint8).reshape(6, 10, 3)[:, ::2],
         "read_only": _read_only,
         "memmap": lambda: _memmap(tmp_path),
         "memmap_view": lambda: _memmap(tmp_path)[1:4],
         "tensor": lambda: torch.arange(90, dtype=torch.uint8).reshape(6, 5, 3),
         "list": lambda: [[0.5, 0.25], [0.75, 0.125]]}[case]()
    want = torch.as_tensor(np.ascontiguousarray(x)).numpy().tobytes()
    for _ in range(3):
        got, rec = _stage(x)
        assert got.numpy().tobytes() == want
        assert rec.attrs.get("registered", False) is False and "register" not in rec.attrs
    assert ("registered" in rec.attrs) == (case not in ("tensor", "list"))
    assert fake.runtime.registers == [] and len(fake) == 0


def test_cpu_device_is_not_sighted(monkeypatch):
    """On the CPU device (the process's registry, whose target is CUDA)
    there is no host-to-device copy: no attribute, nothing remembered,
    the same bytes as before."""
    profiling.clear()
    reg = HostRegistry(FakeRuntime())
    monkeypatch.setattr(tick_mod, "HOSTS", reg)
    (frame,) = _pool("tensor", n=1)
    for _ in range(3):
        got, rec = _stage(frame)
        assert rec.attrs == {"bytes": frame.nbytes}
        assert got.numpy().tobytes() == frame.tobytes()
    assert len(reg) == 0 and reg.runtime.registers == []


def test_runtime_without_a_loaded_cuda_runtime_registers_nothing():
    """Without a CUDA runtime library in the process (this PyTorch build
    has none) a failed registration's error could not be cleared, so
    nothing is registered."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA runtime is loaded")
    a = np.zeros(4096, dtype=np.uint8)
    assert CudaHostRuntime().register(a.ctypes.data, a.nbytes) is False


def test_concurrent_uploads_register_an_owner_once(fake):
    """Many threads staging views of one pool, with a short switch
    interval and a registration that takes a while: the owner is
    registered once and its state stays whole."""
    fake.runtime.delay = 0.05
    pool = _pool("tensor", n=8)
    errors = []

    def stage(i):
        try:
            for k in range(40):
                _stage(pool[(i + k) % 8])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=stage, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(fake.runtime.registers) == 1 and len(fake) == 1
    recs = profiling.spans(names=("serve.stage",))
    assert len(recs) == 16 * 40
    assert sum(bool(r.attrs.get("register")) for r in recs) == 1
    assert sum(not r.attrs["registered"] for r in recs) == 1


@pytest.fixture(scope="module")
def small():
    p = FoveationPipeline(FoveaxConfig(**SMALL), device="cpu")
    host = torch.randint(0, 256, (4, 64, 96, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(5)).numpy()
    return p, [np.ascontiguousarray(host[i]) for i in range(4)]


def test_steady_tick_registers_the_pool_once_and_not_the_gazes(fake, small, monkeypatch):
    """``ServeTick`` over a pool of 4 frames, as the benchmark's broadcast
    cell drives it: the pool's owner registers once, in the second tick;
    the fresh gaze arrays never; the outputs are the unregistered ones."""
    p, pool = small
    tick = ServeTick(p, p.batch_pair("auto"))
    gazes = [(0.5, 0.5), (0.02, 0.9), (0.97, 0.1)]
    outs = []
    for k in range(8):
        with ServeTick.unit(viewers=3):
            outs.append(tick.sample(tick.prepare(pool[k % 4]), gazes))
    assert fake.runtime.registers == [_owner_range(pool[0])]
    recs = profiling.spans(names=("serve.stage",))
    frames = [r for r in recs if r.attrs["bytes"] == pool[0].nbytes]
    assert [r.attrs["registered"] for r in frames] == [False] + [True] * 7
    assert not any(r.attrs["registered"] for r in recs if r.attrs["bytes"] != pool[0].nbytes)
    # today's path: a registry that sights nothing
    monkeypatch.setattr(tick_mod, "HOSTS", HostRegistry(FakeRuntime(), target="none"))
    for k in range(8):
        with ServeTick.unit(viewers=3):
            assert tick.sample(tick.prepare(pool[k % 4]), gazes).tobytes() == outs[k].tobytes()


def test_restore_registers_its_pool_once(fake, small):
    p, _ = small
    host = np.random.default_rng(2).integers(0, 256, (4, 32, 48, 3), dtype=np.uint8)
    pool = [host[i] for i in range(4)]
    restore = ClientRestore(p)
    for k in range(6):
        restore(pool[k % 4], (0.3, 0.6))
    assert fake.runtime.registers == [(host.ctypes.data, host.nbytes)]
    recs = profiling.spans(names=("client.upload",))
    assert [r.attrs["registered"] for r in recs] == [False] + [True] * 5
    assert profiling.counts().get("client.upload_registered", 0) == 5


# ------------------------------------------------------------- the readers

def _rec(a, b, name, **attrs):
    return profiling.Record(name, a, b, 1, None, None, 0, attrs)


FRAME, GAZE = 99_532_800, 64


@pytest.mark.parametrize("metric, name", [("tick.stage_registered_share", "serve.stage"),
                                          ("restore.upload_registered_share", "client.upload")])
@pytest.mark.parametrize("spans, want", [
    # a registered 8K frame beside a fresh gaze array, a tick each: bytes weigh
    ([(FRAME, True), (GAZE, False)] * 3, 100.0 * 3 * FRAME / (3 * FRAME + 3 * GAZE)),
    ([(FRAME, False), (GAZE, False), (FRAME, True), (GAZE, False)], 100.0 * FRAME / (2 * FRAME + 2 * GAZE)),
    ([(FRAME, False)] * 2, 0.0),
    ([], None),
    (None, None),  # spans without the attribute: a program without the mechanism
])
def test_registered_share_readers(monkeypatch, metric, name, spans, want):
    if spans is None:
        recs = [_rec(100, 200, name, bytes=FRAME), _rec(300, 400, name, bytes=GAZE)]
    else:
        recs = [_rec(100 * (2 * i + 1), 100 * (2 * i + 2), name, bytes=b, registered=r)
                for i, (b, r) in enumerate(spans)]
    other = "client.upload" if name == "serve.stage" else "serve.stage"
    recs += [_rec(5_000, 6_000, name, bytes=FRAME, registered=False),  # after the stretch
             _rec(100, 200, other, bytes=FRAME, registered=False)]

    def fake_spans(lo_ns=None, hi_ns=None, names=None):
        return [r for r in recs if r.start >= lo_ns and r.end <= hi_ns
                and (names is None or r.name in names)]

    monkeypatch.setattr(profiling, "spans", fake_spans)
    trace = Trace(2, 0, 1_000, [], [], {}, None, 0)
    got = load_module("metrics", metric).read(trace)
    assert got == (None if want is None else pytest.approx(want))
    if spans and spans[0] == (FRAME, True):
        assert got >= 99.99
