"""The ``"aio"`` (async NVMe I/O) config block.

Counterpart of deeperspeed_tpu/runtime/offload/aio_config.py: the same
keys and defaults."""

AIO = "aio"
AIO_BLOCK_SIZE = "block_size"
AIO_BLOCK_SIZE_DEFAULT = 1048576
AIO_QUEUE_DEPTH = "queue_depth"
AIO_QUEUE_DEPTH_DEFAULT = 8
AIO_THREAD_COUNT = "thread_count"
AIO_THREAD_COUNT_DEFAULT = 1
AIO_SINGLE_SUBMIT = "single_submit"
AIO_SINGLE_SUBMIT_DEFAULT = False
AIO_OVERLAP_EVENTS = "overlap_events"
AIO_OVERLAP_EVENTS_DEFAULT = True


class AioConfig:
    def __init__(self, param_dict=None):
        d = (param_dict or {}).get(AIO, {})
        self.block_size = d.get(AIO_BLOCK_SIZE, AIO_BLOCK_SIZE_DEFAULT)
        self.queue_depth = d.get(AIO_QUEUE_DEPTH, AIO_QUEUE_DEPTH_DEFAULT)
        self.thread_count = d.get(AIO_THREAD_COUNT, AIO_THREAD_COUNT_DEFAULT)
        self.single_submit = d.get(AIO_SINGLE_SUBMIT,
                                   AIO_SINGLE_SUBMIT_DEFAULT)
        self.overlap_events = d.get(AIO_OVERLAP_EVENTS,
                                    AIO_OVERLAP_EVENTS_DEFAULT)

    def __repr__(self):
        return f"AioConfig({vars(self)})"
