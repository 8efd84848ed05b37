"""Synthetic arithmetic-chain reasoning task with an exact golden reward.

A numpy copy of ``repro.data.synthetic`` for the port (which never imports
``repro``): the same seed gives bit-identical problems and batches.

This is the stand-in for MATH500/GSM8K (DESIGN.md §6): the container has no
model checkpoints or datasets, so the paper's accuracy experiments are
reproduced *in structure* on a task where the golden reward r*(x, y) is
computable exactly.

Task: given m numbers, produce the running partial sums as reasoning steps:

    prompt : "a1 + a2 + ... + am ="
    step t : digits of (a1 + ... + a_{t+1})  followed by SEP
    final  : digits of the total followed by EOS

Golden (process) reward of a prefix of steps = fraction of steps so far that
are correct partial sums; a malformed step scores 0 from there on.  Accuracy
= the final answer (last step before EOS) equals the true total.

Vocabulary (token ids):
    0 PAD   1 SEP ("\\n\\n")   2 EOS   3 "+"   4 "="   5..14 digits 0-9
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

PAD, SEP, EOS, PLUS, EQ = 0, 1, 2, 3, 4
D0 = 5            # token id of digit 0
VOCAB = 16        # padded a little


def digits_to_tokens(x: int) -> List[int]:
    return [D0 + int(c) for c in str(int(x))]


def tokens_to_int(toks) -> Optional[int]:
    ds = []
    for t in toks:
        if not (D0 <= t < D0 + 10):
            return None
        ds.append(str(t - D0))
    if not ds:
        return None
    return int("".join(ds))


@dataclass
class Problem:
    numbers: Tuple[int, ...]
    prompt: Tuple[int, ...]

    @property
    def total(self) -> int:
        return sum(self.numbers)

    def partial(self, t: int) -> int:
        return sum(self.numbers[: t + 2])

    @property
    def num_steps(self) -> int:
        return len(self.numbers) - 1


class SyntheticReasoningTask:
    """Generator + golden reward for the arithmetic-chain task."""

    def __init__(self, *, min_terms=3, max_terms=5, max_value=29, seed=0):
        self.min_terms = min_terms
        self.max_terms = max_terms
        self.max_value = max_value
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------
    def sample_problem(self) -> Problem:
        m = int(self.rng.integers(self.min_terms, self.max_terms + 1))
        nums = tuple(int(self.rng.integers(1, self.max_value + 1))
                     for _ in range(m))
        prompt: List[int] = []
        for i, a in enumerate(nums):
            if i:
                prompt.append(PLUS)
            prompt.extend(digits_to_tokens(a))
        prompt.append(EQ)
        return Problem(nums, tuple(prompt))

    def solution_steps(self, prob: Problem) -> List[List[int]]:
        steps = []
        for t in range(prob.num_steps):
            s = digits_to_tokens(prob.partial(t))
            s.append(SEP if t < prob.num_steps - 1 else EOS)
            steps.append(s)
        return steps

    def full_sequence(self, prob: Problem) -> List[int]:
        seq = list(prob.prompt)
        for s in self.solution_steps(prob):
            seq.extend(s)
        return seq

    # ------------------------------------------------------------------
    # Golden reward r*(x, steps) in [0,1]
    # ------------------------------------------------------------------
    def split_steps(self, toks) -> List[List[int]]:
        steps, cur = [], []
        for t in toks:
            if t == PAD:
                continue
            cur.append(int(t))
            if t in (SEP, EOS):
                steps.append(cur)
                cur = []
        if cur:
            steps.append(cur)
        return steps

    def golden_reward(self, prob: Problem, step_tokens_so_far) -> float:
        """Fraction of emitted steps that are correct partial sums."""
        steps = self.split_steps(step_tokens_so_far)
        if not steps:
            return 0.0
        good = 0
        for t, s in enumerate(steps):
            body = [x for x in s if x not in (SEP, EOS)]
            val = tokens_to_int(body)
            if (t < prob.num_steps and val is not None
                    and val == prob.partial(t)):
                good += 1
            else:
                break
        return good / prob.num_steps

    def is_correct(self, prob: Problem, step_tokens) -> bool:
        steps = self.split_steps(step_tokens)
        if not steps or steps[-1][-1] != EOS:
            return False
        body = [x for x in steps[-1] if x not in (SEP, EOS)]
        return tokens_to_int(body) == prob.total

    # ------------------------------------------------------------------
    # LM training batches (next-token prediction over full solutions)
    # ------------------------------------------------------------------
    def lm_batch(self, batch: int, seq_len: int):
        toks = np.full((batch, seq_len), PAD, np.int32)
        mask = np.zeros((batch, seq_len), np.float32)
        for b in range(batch):
            seq = self.full_sequence(self.sample_problem())[:seq_len]
            toks[b, :len(seq)] = seq
            # supervise the solution region only (after EQ)
            eq = seq.index(EQ)
            mask[b, eq:len(seq) - 1] = 1.0
        return {"tokens": toks, "loss_mask": mask}

    # ------------------------------------------------------------------
    # PRM training batches: chains with injected errors + per-token labels
    # ------------------------------------------------------------------
    def prm_batch(self, batch: int, seq_len: int, error_rate=0.45):
        toks = np.full((batch, seq_len), PAD, np.int32)
        labels = np.zeros((batch, seq_len), np.float32)
        mask = np.zeros((batch, seq_len), np.float32)
        for b in range(batch):
            prob = self.sample_problem()
            seq = list(prob.prompt)
            steps = self.solution_steps(prob)
            correct_so_far = 0
            broken = False
            for t, s in enumerate(steps):
                s = list(s)
                if self.rng.random() < error_rate:
                    # corrupt one digit of the step
                    idx = int(self.rng.integers(0, max(1, len(s) - 1)))
                    s[idx] = D0 + int(self.rng.integers(0, 10))
                    val = tokens_to_int([x for x in s if x not in (SEP, EOS)])
                    if val != prob.partial(t):
                        broken = True
                if not broken:
                    correct_so_far += 1
                start = len(seq)
                seq.extend(s)
                if start + len(s) > seq_len:
                    break
                # label every token of the step with the prefix reward
                r = correct_so_far / prob.num_steps
                labels[b, start:start + len(s)] = r
                mask[b, start + len(s) - 1] = 1.0  # train on step-end tokens
            seq = seq[:seq_len]
            toks[b, :len(seq)] = seq
        return {"tokens": toks, "reward_labels": labels, "reward_mask": mask}
