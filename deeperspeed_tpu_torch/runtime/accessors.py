"""Reference-API accessor surface of the training engine.

Counterpart of deeperspeed_tpu/runtime/accessors.py
(``ConfigAccessorsMixin``, ``make_summary_writer``): the same accessors,
read from the config and the optimizer. Requirements on the host class: ``_config``
(TrainingConfig), ``optimizer``, ``lr_scheduler``, ``_client_lr`` and
``_lr_override`` (the set_lr pin, cleared when a scheduler steps).
"""


def make_summary_writer(config, rank: int = 0):
    """TensorBoard monitor for rank 0, or None (the reference's
    ``make_summary_writer``: the writer lives on the first process
    only)."""
    if not getattr(config, "tensorboard_enabled", False) or rank != 0:
        return None
    from ..utils.tensorboard import TensorBoardMonitor

    return TensorBoardMonitor(output_path=config.tensorboard_output_path,
                              job_name=config.tensorboard_job_name)


class ConfigAccessorsMixin:
    """Accessors derived from config/optimizer state."""

    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def zero_optimization_stage(self):
        return self._config.zero_optimization_stage

    def get_batch_info(self):
        """(train_batch_size, micro_batch_per_gpu, grad_accum_steps)."""
        return (self._config.train_batch_size,
                self._config.train_micro_batch_size_per_gpu,
                self._config.gradient_accumulation_steps)

    def _current_lr(self):
        if self._lr_override is not None:
            return self._lr_override
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler.get_lr())
        return float(self._client_lr)

    def get_lr(self):
        return [self._current_lr()]

    def set_lr(self, lr):
        """Pin the learning rate; an active scheduler overwrites it again at
        its next step(), as torch param_groups behave."""
        self._client_lr = float(lr)
        self._lr_override = float(lr)

    def get_mom(self):
        """Momentum/betas of the active optimizer."""
        opt = self.optimizer
        if hasattr(opt, "momentum"):
            return [opt.momentum]
        if hasattr(opt, "betas"):
            return [list(opt.betas)]
        return None

    def memory_breakdown(self):
        return getattr(self._config, "memory_breakdown", False)

    def sparse_gradients_enabled(self):
        return getattr(self._config, "sparse_gradients_enabled", False)

    def wall_clock_breakdown(self):
        return self._config.wall_clock_breakdown

    def optimizer_name(self):
        return self._config.optimizer_name

    def optimizer_params(self):
        return self._config.optimizer_params

    def scheduler_name(self):
        return self._config.scheduler_name

    def scheduler_params(self):
        return self._config.scheduler_params
