"""``restore.readback_fresh_share``'s reader over hand-made spans: the
share of the stretch's ``client.readback`` spans whose ``fresh`` is true,
None with no such span or none that carries the attribute (a program
without the pinned client readback)."""

import pytest

from benchmark.trace import Trace, load_module
from foveax_torch.pipeline import profiling


def _rec(a, b, name="client.readback", **attrs):
    return profiling.Record(name, a, b, 1, None, None, 0, attrs)


@pytest.mark.parametrize("fresh, want", [
    ([False, False, False], 0.0),
    ([True, False], 50.0),
    ([], None),
    (None, None),  # spans without the attribute: a program without the mechanism
])
def test_restore_fresh_share_reader(monkeypatch, fresh, want):
    if fresh is None:
        recs = [_rec(100, 200, bytes=8), _rec(300, 400, bytes=8)]
    else:
        recs = [_rec(100 * (2 * i + 1), 100 * (2 * i + 2), bytes=8, fresh=f)
                for i, f in enumerate(fresh)]
    recs += [_rec(5_000, 6_000, bytes=8, fresh=True),  # after the stretch
             _rec(100, 200, name="serve.readback", fresh=True)]

    def spans(lo_ns=None, hi_ns=None, names=None):
        return [r for r in recs if r.start >= lo_ns and r.end <= hi_ns
                and (names is None or r.name in names)]

    monkeypatch.setattr(profiling, "spans", spans)
    trace = Trace(2, 0, 1_000, [], [], {}, None, 0)
    assert load_module("metrics", "restore.readback_fresh_share").read(trace) == want
