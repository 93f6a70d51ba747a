"""The traffic generator and the tokenizer: a seed fixes the plan, and
every seed gets the same sizes in another order."""
from collections import Counter

import _tiny
from ptts_bench import traffic


def test_plan_is_deterministic_for_a_seed():
    mix = _tiny.mix()
    a = traffic.plan(mix, 2 ** 31 + 7)
    b = traffic.plan(mix, 2 ** 31 + 7)
    assert [(p.text, p.voice, p.seed) for p in a] == [
        (p.text, p.voice, p.seed) for p in b]
    c = traffic.plan(mix, 5)
    assert [p.text for p in a] != [p.text for p in c]


def test_every_seed_gets_the_same_sizes():
    mix = _tiny.mix()
    a, b = traffic.plan(mix, 1), traffic.plan(mix, 99)
    assert Counter(p.words for p in a) == Counter(p.words for p in b)
    assert Counter(p.voice for p in a) == Counter(p.voice for p in b)
    assert sorted(traffic.voice_order(mix, 1)) == sorted(
        traffic.voice_order(mix, 99))
    assert all(len(p.text.split()) == p.words for p in a)


def test_cell_mix_sizes():
    mix = traffic.load("sessions256", _tiny.ROOT)
    plan = traffic.plan(mix, 3)
    words = [p.words for p in plan]
    assert min(words) == 4 and max(words) == 40
    assert sorted(words)[len(words) // 2] == 10
    counts = Counter(p.voice for p in plan)
    assert counts["v0"] > counts["v1"] > counts["v7"]
    tok = traffic.WordTokenizer(4000)
    longest = max(plan, key=lambda p: p.words)
    ids = tok.encode(longest.text + ".")
    assert len(ids) <= mix["text_bucket"]
    assert all(0 <= i < 4000 for i in ids)


def test_open_loop_arrivals():
    mix = dict(_tiny.mix(), arrivals={"kind": "open", "rate_per_s": 50.0,
                                      "burst_factor": 4.0, "burst_s": 1.0,
                                      "calm_s": 3.0})
    plan = traffic.plan(mix, 11)
    due = [p.due_s for p in plan]
    assert due == sorted(due) and due[0] > 0
    assert 50.0 < len(due) / due[-1] < 200.0
