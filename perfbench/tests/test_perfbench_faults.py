"""A run with its timed path broken underneath comes out not correct:
the harness's look for a chip skipped, the rest of the run driven on the
CPU at a tiny size, once for each fault of `lib/faults.py` a cell can
have (one chip, so no exchange between chips): a step that returns its
state unchanged, half of the batch left out with the mean over the
rest, a scatter that averages a row's repeated lookups, a step that
leaves the dense layers as they were, and for scoring half of the batch
left out or an answer altered where it is produced."""
import pytest

from perfbench.lib import faults, harness
from perfbench.tests import tiny

TRAIN = ["dlrm-criteo.train-resident", "wide-deep.train-resident",
         "dlrm-criteo.train-fed", "dlrm-criteo.train-uniform"]


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", list(faults.TRAIN))
def test_a_broken_train_step_is_not_correct(name, fault):
    line = harness.run(tiny.cell(name, batch=512), 2**32 + 3, 0.3, False,
                       "cpu", fault=faults.TRAIN[fault])
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", list(faults.SCORE))
def test_a_broken_score_is_not_correct(fault):
    line = harness.run(tiny.cell("dlrm-criteo.serve-bulk", batch=512),
                       2**32 + 5, 0.3, False, "cpu",
                       fault=faults.SCORE[fault])
    assert line["correct"] is False, line["checks"]
