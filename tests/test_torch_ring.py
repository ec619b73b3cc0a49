"""The port's consistent-hash ring (``sentinel_tpu_torch.cluster.ring``)
against the JAX package's.

The counterparts of tests/test_ring.py: the port's ring gives the
reference's owner for every key of a fixed set (500 raw keys and 300 flow
keys) over 1–8 members at vnodes 1 and 64, and the reference's golden
assignment; a one-member edit moves at most one share, only the
departing or arriving member's keys, the same keys as the reference's
ring, and incremental edits equal a fresh build; ``spread`` and
``flow_key`` equal the reference's; the same validation errors, message
for message.  Everything compared is a string or an integer: equal.
"""

from __future__ import annotations

import math

import pytest

from sentinel_tpu.cluster import ring as JR
from sentinel_tpu_torch.cluster import ring as TR
from tests.test_ring import GOLDEN_FLOWS_V32, GOLDEN_V32, MEMBERS

KEYS = [f"key-{i}" for i in range(500)] + [TR.flow_key(f) for f in range(100, 400)]


@pytest.mark.parametrize("vnodes", [1, 64])
@pytest.mark.parametrize("n", range(1, 9))
def test_owner_equals_the_reference_for_every_key(n, vnodes):
    members = [f"shard-{i}" for i in range(n)]
    port, ref = TR.HashRing(members, vnodes=vnodes), JR.HashRing(members, vnodes=vnodes)
    assert port.assignment(KEYS) == ref.assignment(KEYS)
    assert [port.owner_of_flow(f) for f in range(100, 400)] == [ref.owner_of_flow(f) for f in range(100, 400)]
    assert port._table == ref._table  # the one published (hashes, points) pair, tie-break included
    assert port.members == ref.members and port.vnodes == ref.vnodes == vnodes


def test_the_reference_golden_assignment_holds_on_the_port():
    ring = TR.HashRing(MEMBERS, vnodes=32)
    assert [int(ring.owner(f"k{i}").split("-")[1]) for i in range(64)] == GOLDEN_V32
    for fid, owner in GOLDEN_FLOWS_V32.items():
        assert ring.owner_of_flow(fid) == owner
    assert TR.DEFAULT_VNODES == JR.DEFAULT_VNODES == 64
    # construction order is irrelevant, as in the reference
    assert TR.HashRing(list(reversed(MEMBERS))).assignment(KEYS) == TR.HashRing(MEMBERS).assignment(KEYS)


@pytest.mark.parametrize("edit", ["remove", "add"])
def test_a_membership_edit_moves_at_most_one_share_as_the_reference(edit):
    keys = [f"key-{i}" for i in range(512)]
    moved = {}
    for name, m in (("port", TR), ("ref", JR)):
        before = m.HashRing([f"s{i}" for i in range(4)]).assignment(keys)
        after = m.HashRing([f"s{i}" for i in range(3 if edit == "remove" else 5)]).assignment(keys)
        moved[name] = sorted(k for k in keys if before[k] != after[k])
        if edit == "remove":
            assert all(before[k] == "s3" for k in moved[name])
        else:
            assert all(after[k] == "s4" for k in moved[name])
    assert 0 < len(moved["port"]) <= math.ceil(512 / 4) + 512 // 8
    assert moved["port"] == moved["ref"]


def test_incremental_edits_match_a_fresh_build_and_the_reference():
    keys = [f"key-{i}" for i in range(256)]
    got = {}
    for name, m in (("port", TR), ("ref", JR)):
        ring = m.HashRing(MEMBERS)
        ring.add("shard-4")
        ring.remove("shard-1")
        fresh = m.HashRing(["shard-0", "shard-2", "shard-3", "shard-4"])
        assert ring.assignment(keys) == fresh.assignment(keys)
        got[name] = (ring.members, ring.assignment(keys))
    assert got["port"] == got["ref"]


def test_spread_and_flow_key_equal_the_reference():
    keys = [f"key-{i}" for i in range(1000)]
    spread = TR.HashRing(MEMBERS).spread(keys)
    assert spread == JR.HashRing(MEMBERS).spread(keys)
    assert set(spread) == set(MEMBERS) and all(v > 0 for v in spread.values()) and sum(spread.values()) == 1000
    assert [TR.flow_key(f) for f in (0, 42, -3, 2**40)] == [JR.flow_key(f) for f in (0, 42, -3, 2**40)]
    assert TR.flow_key(42) == "flow/42"
    assert [TR._h(k) for k in KEYS[:50]] == [JR._h(k) for k in KEYS[:50]]


def _errors(m) -> list:
    out = []

    def catch(fn):
        try:
            fn()
            out.append(None)
        except ValueError as e:
            out.append(str(e))

    catch(lambda: m.HashRing([]))
    catch(lambda: m.HashRing(["a", "a"]))
    catch(lambda: m.HashRing(["a"], vnodes=0))
    ring = m.HashRing(["a", "b"])
    catch(lambda: ring.add("a"))
    catch(lambda: ring.remove("zz"))
    catch(lambda: ring.remove("b"))
    catch(lambda: ring.remove("a"))  # never empty
    return out


def test_the_same_validation_errors():
    port = _errors(TR)
    assert port == _errors(JR)
    assert port.count(None) == 1 and port[5] is None  # only the first remove of a present member succeeds
