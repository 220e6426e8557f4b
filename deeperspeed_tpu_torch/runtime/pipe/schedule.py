"""Pipeline instruction schedules.

Counterpart of deeperspeed_tpu/runtime/pipe/schedule.py, instruction for
instruction (pure Python, no tensors): ``PipeSchedule``,
``TrainSchedule`` (1F1B-interleaved, 2*(micro_batches + stages - 1)
steps), ``InferenceSchedule``, ``DataParallelSchedule`` and the
instruction classes.

A schedule yields, per step, the list of instructions one stage executes.
In the port each stage is its own process (runtime/pipe/engine.py runs
only its own stage's stream), so the steps are not barrier-aligned
across stages: a send on stage ``s`` pairs with the matching recv on
``s +- 1`` by their order on that pipe edge, first in first out
(runtime/pipe/p2p.py).
"""

from abc import ABC, abstractmethod

from ..utils import call_to_str


class PipeSchedule(ABC):
    """Generates the instruction stream for one stage of the pipeline.

    Args:
        micro_batches: number of micro-batches in one global batch.
        stages: number of pipeline stages.
        stage_id: which stage this schedule drives.
    """

    def __init__(self, micro_batches, stages, stage_id):
        super().__init__()
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = self.stage_id - 1
        self.next_stage = self.stage_id + 1

    @abstractmethod
    def steps(self):
        """Yield a list of :class:`PipeInstruction` per schedule step."""

    def num_pipe_buffers(self):
        """How many in-flight activation buffers this stage needs."""
        return self.micro_batches

    def _valid_micro_batch(self, micro_batch_id):
        return 0 <= micro_batch_id < self.micro_batches

    def _valid_stage(self, stage_id):
        return 0 <= stage_id < self.stages

    @property
    def stage(self):
        return self.stage_id

    @property
    def num_stages(self):
        return self.stages

    @property
    def num_micro_batches(self):
        return self.micro_batches

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.stages - 1

    def _buffer_idx(self, micro_batch_id):
        """Cyclic buffer allocation for an in-flight micro-batch."""
        assert self._valid_micro_batch(micro_batch_id)
        return micro_batch_id % self.num_pipe_buffers()

    def __iter__(self):
        return iter(self.steps())


class TrainSchedule(PipeSchedule):
    """1F1B-interleaved training schedule .

    Every stage alternates forward-slot / backward-slot steps; stage ``s``
    sees its first forward at step ``s`` and its first backward once that
    micro-batch has travelled to the last stage and back. Convergence is
    identical to data parallelism with the same global batch.
    """

    def steps(self):
        prev_micro_batch_id = -1
        total_steps = 2 * (self.micro_batches + self.stages - 1)
        for step_id in range(total_steps):
            micro_batch_id, is_forward = self._step_to_micro_batch(step_id)

            cmds = []

            # Activation / gradient exchange. A forward-slot step receives the
            # activation it is about to consume and returns the grad for the
            # previous (backward-slot) micro-batch; a backward-slot step ships
            # the freshly produced activation downstream and receives the
            # gradient it is about to consume.
            if is_forward:
                if self._valid_micro_batch(micro_batch_id) and self._valid_stage(
                    self.prev_stage
                ):
                    cmds.append(RecvActivation(self._buffer_idx(micro_batch_id)))
                if self._valid_micro_batch(prev_micro_batch_id) and self._valid_stage(
                    self.prev_stage
                ):
                    cmds.append(SendGrad(self._buffer_idx(prev_micro_batch_id)))
            else:
                if self._valid_micro_batch(prev_micro_batch_id) and self._valid_stage(
                    self.next_stage
                ):
                    cmds.append(SendActivation(self._buffer_idx(prev_micro_batch_id)))
                if self._valid_micro_batch(micro_batch_id) and self._valid_stage(
                    self.next_stage
                ):
                    cmds.append(RecvGrad(self._buffer_idx(micro_batch_id)))

            # First and last stage pull micro-batch data from the loader.
            if self.stage_id == 0 or self.stage_id == self.stages - 1:
                if is_forward and self._valid_micro_batch(micro_batch_id):
                    cmds.append(LoadMicroBatch(self._buffer_idx(micro_batch_id)))

            # Compute.
            if self._valid_micro_batch(micro_batch_id):
                if is_forward:
                    cmds.append(ForwardPass(self._buffer_idx(micro_batch_id)))
                else:
                    cmds.append(BackwardPass(self._buffer_idx(micro_batch_id)))

            # Optimizer step once the whole batch has drained.
            if step_id == total_steps - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())

            prev_micro_batch_id = micro_batch_id
            yield cmds

    def num_pipe_buffers(self):
        """In-flight buffers = distance to the last stage (+1), capped by the
        micro-batch count, floored at 2."""
        return max(2, min(self.stages - self.stage_id + 1, self.micro_batches))

    def _step_to_micro_batch(self, step_id):
        """Map a step to (micro_batch_id, is_forward).

        A stage with parity ``p = stage_id % 2`` takes forward slots on steps
        of the same parity. Forward ids advance one per two steps, delayed by
        the stage's position in the pipe; backward ids additionally lag by
        the round-trip to the last stage.
        """
        p = self.stage_id % 2
        if step_id % 2 == p:
            micro_batch_id = (step_id - p) // 2 - self.stage_id // 2
            return micro_batch_id, True
        q = 1 - p
        micro_batch_id = (
            (step_id - q) // 2 - (self.stages - 1) + (self.stage_id + p) // 2 - p
        )
        return micro_batch_id, False


class InferenceSchedule(PipeSchedule):
    """Forward-only pipelining with two alternating buffers."""

    def steps(self):
        total_steps = self.micro_batches + self.stages - 1
        for step_id in range(total_steps):
            cmds = []
            micro_batch_id = step_id - self.stage_id

            # Two alternating buffers; even/odd stages swap roles so that a
            # send on stage s and the recv on s+1 use the same buffer slot.
            if self.stage_id % 2 == 0:
                recv_buf = step_id % 2
                send_buf = (step_id + 1) % 2
            else:
                recv_buf = (step_id + 1) % 2
                send_buf = step_id % 2

            if self.is_first_stage or self.is_last_stage:
                if self._valid_micro_batch(micro_batch_id):
                    cmds.append(LoadMicroBatch(recv_buf))

            if self.stage_id % 2 == 0:
                if self._valid_stage(self.next_stage) and self._valid_micro_batch(
                    micro_batch_id - 1
                ):
                    cmds.append(SendActivation(send_buf))
                if self._valid_stage(self.prev_stage) and self._valid_micro_batch(
                    micro_batch_id
                ):
                    cmds.append(RecvActivation(recv_buf))
            else:
                if self._valid_stage(self.prev_stage) and self._valid_micro_batch(
                    micro_batch_id
                ):
                    cmds.append(RecvActivation(recv_buf))
                if self._valid_stage(self.next_stage) and self._valid_micro_batch(
                    micro_batch_id - 1
                ):
                    cmds.append(SendActivation(send_buf))

            if self._valid_micro_batch(micro_batch_id):
                cmds.append(ForwardPass(recv_buf))

            yield cmds

    def num_pipe_buffers(self):
        return 2


class DataParallelSchedule(PipeSchedule):
    """Plain gradient-accumulation data parallelism expressed as a pipeline
    schedule."""

    def steps(self):
        for step_id in range(self.micro_batches):
            cmds = [
                LoadMicroBatch(buffer_id=0),
                ForwardPass(buffer_id=0),
                BackwardPass(buffer_id=0),
            ]
            if step_id == self.micro_batches - 1:
                cmds.extend([ReduceGrads(), OptimizerStep()])
            yield cmds

    def num_pipe_buffers(self):
        return 1


# ------------------------------------------------------------------ #
# instructions
# ------------------------------------------------------------------ #


class PipeInstruction:
    """Base instruction; kwargs become attributes."""

    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for key, val in kwargs.items():
            setattr(self, key, val)

    def __repr__(self):
        return call_to_str(self.name, **self.kwargs)

    def __eq__(self, other):
        return type(self) is type(other) and self.kwargs == other.kwargs

    def __hash__(self):
        return hash((self.name, tuple(sorted(self.kwargs.items()))))


class OptimizerStep(PipeInstruction):
    """Apply the optimizer and zero gradients; after Reduce(Tied)Grads."""


class ReduceGrads(PipeInstruction):
    """All-reduce accumulated gradients across the data-parallel axis."""


class ReduceTiedGrads(PipeInstruction):
    """Sum gradients of tied modules across the pipeline stages owning them."""


class BufferOpInstruction(PipeInstruction):
    """Instruction operating on a numbered pipeline buffer."""

    def __init__(self, buffer_id, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    """buffers['inputs'][buffer_id] = next(data_iter) (first/last stage)."""


class ForwardPass(BufferOpInstruction):
    """buffers['outputs'][buffer_id] = fwd(buffers['inputs'][buffer_id])."""


class BackwardPass(BufferOpInstruction):
    """Apply the stage VJP to buffers['grads'][buffer_id], accumulating
    parameter gradients and producing the input gradient to send upstream."""


class SendActivation(BufferOpInstruction):
    """Ship buffers['outputs'][buffer_id] to the next stage (blocking pair
    with RecvActivation)."""


class RecvActivation(BufferOpInstruction):
    """Fill buffers['inputs'][buffer_id] from the previous stage."""


class SendGrad(BufferOpInstruction):
    """Ship the input-gradient for buffer_id to the previous stage."""


class RecvGrad(BufferOpInstruction):
    """Fill buffers['grads'][buffer_id] from the next stage."""
