"""The port's data pipeline against ``repro.data``: bit-identical.

``repro_torch.data`` is a numpy copy of the reference's (the port never
imports ``repro``), so the same seed must give the same problems,
solutions, golden rewards and LM / PRM batches, and the same random-token
stream, bit for bit; ``OracleRewardModel`` must score as the reference's.
"""
import numpy as np
import pytest

from repro.data import SyntheticReasoningTask as JTask
from repro.data.lm import lm_batches as jlm_batches
from repro.rewards.prm import OracleRewardModel as JOracle
from repro_torch.data import SyntheticReasoningTask, lm_batches
from repro_torch.data import synthetic
from repro_torch.data.lm import prefetch
from repro_torch.rewards import OracleRewardModel


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("seed,terms", [(0, (3, 5)), (7, (2, 6))])
def test_synthetic_task_is_bit_identical(seed, terms):
    kw = dict(min_terms=terms[0], max_terms=terms[1], seed=seed)
    ref, port = JTask(**kw), SyntheticReasoningTask(**kw)
    for _ in range(20):
        a, b = ref.sample_problem(), port.sample_problem()
        assert (a.numbers, a.prompt) == (b.numbers, b.prompt)
        assert ref.solution_steps(a) == port.solution_steps(b)
        assert ref.full_sequence(a) == port.full_sequence(b)
    _same(ref.lm_batch(6, 20), port.lm_batch(6, 20))
    _same(ref.prm_batch(6, 24), port.prm_batch(6, 24))
    _same(ref.prm_batch(3, 40, error_rate=0.9),
          port.prm_batch(3, 40, error_rate=0.9))
    # the streams stay in step after all of the above
    assert ref.rng.integers(1 << 30) == port.rng.integers(1 << 30)


def test_golden_reward_and_correctness_match():
    ref, port = JTask(seed=3), SyntheticReasoningTask(seed=3)
    oracle_ref, oracle = JOracle(ref), OracleRewardModel(port)
    rng = np.random.default_rng(0)
    probs, attempts = [], []
    for _ in range(30):
        prob = port.sample_problem()
        ref.sample_problem()
        steps = [t for s in port.solution_steps(prob) for t in s]
        cut = rng.integers(0, len(steps) + 1)
        toks = list(steps[:cut])
        if toks and rng.random() < 0.5:      # corrupt one token
            toks[rng.integers(len(toks))] = int(rng.integers(0, 16))
        probs.append(prob)
        attempts.append(toks + [synthetic.PAD] * int(rng.integers(0, 3)))
    for prob, toks in zip(probs, attempts):
        assert port.golden_reward(prob, toks) == ref.golden_reward(prob, toks)
        assert port.is_correct(prob, toks) == ref.is_correct(prob, toks)
        assert port.split_steps(toks) == ref.split_steps(toks)
    assert np.array_equal(oracle.batch_reward(probs, attempts),
                          oracle_ref.batch_reward(probs, attempts))
    assert synthetic.tokens_to_int([]) is None
    assert synthetic.digits_to_tokens(407) == [9, 5, 12]


@pytest.mark.parametrize("shard_index,shard_count", [(0, 1), (1, 2)])
def test_lm_batches_are_bit_identical(shard_index, shard_count):
    kw = dict(seed=5, num_batches=4, shard_index=shard_index,
              shard_count=shard_count)
    ref = list(jlm_batches(1000, 8, 12, **kw))
    port = list(lm_batches(1000, 8, 12, **kw))
    assert len(ref) == len(port) == 4
    for a, b in zip(ref, port):
        _same(a, b)
    # the host prefetch thread keeps the order and ends the stream
    fetched = list(prefetch(lm_batches(1000, 8, 12, **kw), depth=2))
    assert len(fetched) == 4
    for a, b in zip(fetched, port):
        _same(a, b)
