"""The port's pipeline schedules (runtime/pipe/schedule.py) against the
JAX reference's: for every (micro_batches, stages) case and every stage,
``TrainSchedule``, ``InferenceSchedule`` and ``DataParallelSchedule``
yield the same instructions, step by step (type and buffer id), and ask
for the same number of pipe buffers. Pure Python: exact equality."""

import pytest

from deeperspeed_tpu.runtime.pipe import schedule as ref
from deeperspeed_tpu_torch.runtime.pipe import schedule as port

CASES = [(1, 1), (2, 2), (4, 2), (3, 3), (8, 4), (2, 4)]
KINDS = ("TrainSchedule", "InferenceSchedule", "DataParallelSchedule")


def _stream(sched):
    return [[(type(c).__name__, tuple(sorted(c.kwargs.items())))
             for c in step] for step in sched.steps()]


@pytest.mark.parametrize("micro,stages", CASES)
def test_streams_equal_reference(micro, stages):
    for kind in KINDS:
        for sid in range(stages):
            want = getattr(ref, kind)(micro, stages, sid)
            got = getattr(port, kind)(micro, stages, sid)
            assert _stream(got) == _stream(want), (kind, sid)
            assert got.num_pipe_buffers() == want.num_pipe_buffers()
            assert [repr(c) for s in got for c in s] == \
                [repr(c) for s in want for c in s]
