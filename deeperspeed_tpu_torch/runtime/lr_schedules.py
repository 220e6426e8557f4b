"""LR schedules: LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR.

Counterpart of deeperspeed_tpu/runtime/lr_schedules.py, kept as this
package's own copy: the same classes, defaults, formulas and CLI tuning
arguments. Schedulers are host-side objects; the engine reads
``get_lr()`` once per optimizer step.
"""

import argparse
import math

LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

LR_RANGE_TEST_MIN_LR = "lr_range_test_min_lr"
LR_RANGE_TEST_STEP_RATE = "lr_range_test_step_rate"
LR_RANGE_TEST_STEP_SIZE = "lr_range_test_step_size"
LR_RANGE_TEST_STAIRCASE = "lr_range_test_staircase"

CYCLE_FIRST_STEP_SIZE = "cycle_first_step_size"
CYCLE_FIRST_STAIR_COUNT = "cycle_first_stair_count"
CYCLE_SECOND_STEP_SIZE = "cycle_second_step_size"
CYCLE_SECOND_STAIR_COUNT = "cycle_second_stair_count"
DECAY_STEP_SIZE = "decay_step_size"
CYCLE_MIN_LR = "cycle_min_lr"
CYCLE_MAX_LR = "cycle_max_lr"
DECAY_LR_RATE = "decay_lr_rate"
CYCLE_MIN_MOM = "cycle_min_mom"
CYCLE_MAX_MOM = "cycle_max_mom"
DECAY_MOM_RATE = "decay_mom_rate"

WARMUP_MIN_LR = "warmup_min_lr"
WARMUP_MAX_LR = "warmup_max_lr"
WARMUP_NUM_STEPS = "warmup_num_steps"
TOTAL_NUM_STEPS = "total_num_steps"


def add_tuning_arguments(parser):
    group = parser.add_argument_group("Convergence Tuning", "Convergence tuning configurations")
    group.add_argument("--lr_schedule", type=str, default=None, help="LR schedule for training.")
    # LRRangeTest
    group.add_argument("--lr_range_test_min_lr", type=float, default=0.001)
    group.add_argument("--lr_range_test_step_size", type=int, default=1000)
    group.add_argument("--lr_range_test_step_rate", type=float, default=1.0)
    group.add_argument("--lr_range_test_staircase", type=bool, default=False)
    # OneCycle
    group.add_argument("--cycle_first_step_size", type=int, default=1000)
    group.add_argument("--cycle_first_stair_count", type=int, default=-1)
    group.add_argument("--cycle_second_step_size", type=int, default=-1)
    group.add_argument("--cycle_second_stair_count", type=int, default=-1)
    group.add_argument("--decay_step_size", type=int, default=1000)
    group.add_argument("--cycle_min_lr", type=float, default=0.01)
    group.add_argument("--cycle_max_lr", type=float, default=0.1)
    group.add_argument("--decay_lr_rate", type=float, default=0.0)
    group.add_argument("--cycle_min_mom", type=float, default=0.8)
    group.add_argument("--cycle_max_mom", type=float, default=0.9)
    group.add_argument("--decay_mom_rate", type=float, default=0.0)
    # Warmup
    group.add_argument("--warmup_min_lr", type=float, default=0)
    group.add_argument("--warmup_max_lr", type=float, default=0.001)
    group.add_argument("--warmup_num_steps", type=int, default=1000)
    return parser


def parse_arguments():
    parser = argparse.ArgumentParser()
    parser = add_tuning_arguments(parser)
    lr_sched_args, unknown_args = parser.parse_known_args()
    return lr_sched_args, unknown_args


class _BaseSchedule:
    """Common step/state plumbing (torch-scheduler-like surface)."""

    def __init__(self, last_batch_iteration=-1):
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self):
        raise NotImplementedError

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        return self.get_lr()

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]

    # mirror torch API used by callers
    def get_last_lr(self):
        return [self.get_lr()]


class LRRangeTest(_BaseSchedule):
    """Linear/staircase increasing LR sweep (reference lr_schedules.py:301)."""

    def __init__(
        self,
        optimizer=None,
        lr_range_test_min_lr=1e-3,
        lr_range_test_step_size=2000,
        lr_range_test_step_rate=1.0,
        lr_range_test_staircase=False,
        last_batch_iteration=-1,
    ):
        super().__init__(last_batch_iteration)
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def get_lr(self):
        it = max(self.last_batch_iteration, 0)
        count = it // self.step_size if self.staircase else it / self.step_size
        return self.min_lr * (1 + self.step_rate * count)


class OneCycle(_BaseSchedule):
    """1-cycle policy with optional post-cycle decay and momentum cycling
    (reference lr_schedules.py:408)."""

    def __init__(
        self,
        optimizer=None,
        cycle_min_lr=0.01,
        cycle_max_lr=0.1,
        decay_lr_rate=0.0,
        cycle_first_step_size=2000,
        cycle_second_step_size=None,
        cycle_first_stair_count=0,
        cycle_second_stair_count=None,
        decay_step_size=0,
        cycle_momentum=True,
        cycle_min_mom=0.8,
        cycle_max_mom=0.9,
        decay_mom_rate=0.0,
        last_batch_iteration=-1,
    ):
        super().__init__(last_batch_iteration)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_step_size = cycle_first_step_size
        self.second_step_size = (
            cycle_second_step_size if cycle_second_step_size else cycle_first_step_size
        )
        self.decay_step_size = decay_step_size
        self.total_cycle_size = self.first_step_size + self.second_step_size
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate

    def _cycle_pos(self, it):
        """Returns scale in [0,1]: 0 at cycle edges, 1 at peak."""
        pos = it % self.total_cycle_size if self.total_cycle_size else 0
        if pos <= self.first_step_size:
            return pos / self.first_step_size
        return 1.0 - (pos - self.first_step_size) / self.second_step_size

    def get_lr(self):
        it = max(self.last_batch_iteration, 0)
        if it < self.total_cycle_size:
            scale = self._cycle_pos(it)
            return self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * scale
        # decay phase
        decay_steps = it - self.total_cycle_size
        if self.decay_step_size > 0 and self.decay_lr_rate > 0:
            intervals = decay_steps // self.decay_step_size
            return self.cycle_min_lr / (1.0 + self.decay_lr_rate * intervals)
        return self.cycle_min_lr

    def get_mom(self):
        if not self.cycle_momentum:
            return None
        it = max(self.last_batch_iteration, 0)
        if it < self.total_cycle_size:
            scale = self._cycle_pos(it)
            # momentum moves opposite to lr
            return self.cycle_max_mom - (self.cycle_max_mom - self.cycle_min_mom) * scale
        decay_steps = it - self.total_cycle_size
        if self.decay_step_size > 0 and self.decay_mom_rate > 0:
            intervals = decay_steps // self.decay_step_size
            return self.cycle_max_mom * (1.0 + self.decay_mom_rate * intervals)
        return self.cycle_max_mom


class WarmupLR(_BaseSchedule):
    """Linear warmup from min to max then constant (reference
    lr_schedules.py:677)."""

    def __init__(
        self,
        optimizer=None,
        warmup_min_lr=0.0,
        warmup_max_lr=0.001,
        warmup_num_steps=1000,
        last_batch_iteration=-1,
    ):
        super().__init__(last_batch_iteration)
        self.min_lr = warmup_min_lr
        self.max_lr = warmup_max_lr
        self.warmup_num_steps = max(1, warmup_num_steps)
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps + 1)

    def _warmup_scale(self, it):
        if it < self.warmup_num_steps:
            return self.inverse_log_warm_up * math.log(it + 1)
        return 1.0

    def get_lr(self):
        it = max(self.last_batch_iteration, 0)
        scale = self._warmup_scale(it)
        return self.min_lr + (self.max_lr - self.min_lr) * scale


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to zero at total_num_steps (reference
    lr_schedules.py:761)."""

    def __init__(
        self,
        optimizer=None,
        total_num_steps=10000,
        warmup_min_lr=0.0,
        warmup_max_lr=0.001,
        warmup_num_steps=1000,
        last_batch_iteration=-1,
    ):
        self.total_num_steps = total_num_steps
        super().__init__(
            optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps, last_batch_iteration
        )

    def _warmup_scale(self, it):
        if it < self.warmup_num_steps:
            return self.inverse_log_warm_up * math.log(it + 1)
        return max(
            0.0,
            (self.total_num_steps - it)
            / max(1, self.total_num_steps - self.warmup_num_steps),
        )


SCHEDULES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
}


def get_scheduler(name, params, optimizer=None):
    if name not in SCHEDULES:
        raise ValueError(f"unknown lr schedule {name}; valid: {list(SCHEDULES)}")
    return SCHEDULES[name](optimizer=optimizer, **params)
