"""``examples/accuracy_study_torch.py`` against the reference's
``benchmarks/softmax_accuracy.run(steps=10)``, which
``examples/accuracy_study.py`` prints: the port's copy of ``run`` from the
reference's ``PRNGKey(0)`` parameters, bridged, on the reference's
batches.

Tolerances: the two probability errors within 1e-6 (the same LUT pair on
the same scores; measured 6e-8 and 4e-12); the final train loss within
1e-4 relatively (10 f32 QAT steps; measured 1.2e-5); the next-token TV
within 5e-4 absolutely (measured 4.8e-5); the band accuracies within 8
of their 2016 (4 x 8 x 63) positions (measured 4, float, and 2, int8)
and the top-1 agreement within 24 of its 2048 (4 x 8 x 64) (measured
12).  Ten steps leave the model close to uniform over the HMM bands, so
many positions are near-ties, and the two frameworks' trained weights
differ where AdamW takes a full step on a gradient near zero (see
``test_torch_examples_quickstart.py``).
"""
from pathlib import Path

import pytest
import torch

from test_torch_examples_quickstart import bridged_params, jax_batches, load

ROOT = Path(__file__).resolve().parent.parent
# (positions, tolerance) of each count: the band accuracies score every
# position but the last of the eval batches' rows, the top-1 every one
COUNTS = {"accuracy.task_float": (4 * 8 * 63, 8),
          "accuracy.task_int8_lut": (4 * 8 * 63, 8),
          "accuracy.top1_agreement": (4 * 8 * 64, 24)}
STEPS = 10

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rows():
    ref = load(ROOT / "benchmarks" / "softmax_accuracy.py",
                "jax_softmax_accuracy")
    want = {name: val for name, val, _ in ref.run(steps=STEPS)}
    study = load(ROOT / "examples" / "accuracy_study_torch.py",
                  "accuracy_study_torch")
    cfg = study.study_config()
    got = study.run(steps=STEPS, params=bridged_params(cfg), device="cpu",
                    batch_fn=jax_batches)
    return want, {name: val for name, val, _ in got}, got


def test_same_rows(rows):
    want, got, _ = rows
    assert list(got) == list(want)


@pytest.mark.parametrize("name", ["accuracy.prob_max_err",
                                  "accuracy.prob_mean_err"])
def test_probability_errors_within_1e_6(rows, name):
    want, got, _ = rows
    assert abs(got[name] - want[name]) <= 1e-6, (got[name], want[name])


def test_train_loss_and_tv(rows):
    want, got, _ = rows
    assert abs(got["accuracy.train_loss"] / want["accuracy.train_loss"]
               - 1) <= 1e-4
    assert abs(got["accuracy.next_token_tv"]
               - want["accuracy.next_token_tv"]) <= 5e-4


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_accuracies_within_a_count_of_positions(rows, name):
    want, got, _ = rows
    positions, tol = COUNTS[name]
    assert round(abs(got[name] - want[name]) * positions) <= tol, \
        (got[name], want[name])


def test_rows_carry_their_labels(rows):
    _, _, listed = rows
    derived = dict((name, text) for name, _, text in listed)
    assert derived["accuracy.train_loss"] == f"{STEPS} steps, smoke model"
    assert "paper: within +-0.6%" in derived["accuracy.task_int8_lut"]
