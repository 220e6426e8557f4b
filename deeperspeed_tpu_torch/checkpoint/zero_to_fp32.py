"""Offline checkpoint -> consolidated fp32 weights tool.

Counterpart of deeperspeed_tpu/checkpoint/zero_to_fp32.py: reads a
checkpoint directory in the msgpack layout (either package's) and writes
its fp32 master weights (or, for fp32 training, the module) as one
msgpack file.

CLI (``Engine.save_checkpoint`` drops a stub that runs it into every
checkpoint directory, as the reference copies the tool itself):

    python -m deeperspeed_tpu_torch.checkpoint.zero_to_fp32 <ckpt_dir> <out.msgpack>
"""

import argparse
import math
import os

from .serialization import consolidate_fp32_state, read_latest, save_tree

RECOVERY_SCRIPT = "zero_to_fp32.py"

_STUB = """#!/usr/bin/env python
# Auto-generated recovery stub: consolidate this checkpoint's state into a
# single fp32 weight file.
#   python zero_to_fp32.py . pytorch_model.msgpack
# Needs the deeperspeed_tpu_torch package importable (installed or on
# PYTHONPATH); the saver's install path is tried as a fallback.
import os, sys
try:
    from deeperspeed_tpu_torch.checkpoint.zero_to_fp32 import main
except ImportError:
    sys.path.insert(0, {pkg_root!r})
    from deeperspeed_tpu_torch.checkpoint.zero_to_fp32 import main
if __name__ == "__main__":
    main()
"""


def write_recovery_stub(ckpt_dir: str):
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(ckpt_dir, RECOVERY_SCRIPT)
    with open(path, "w") as f:
        f.write(_STUB.format(pkg_root=pkg_root))
    return path


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str,
                                               output_file: str, tag=None):
    """The reference's ``convert_zero_checkpoint_to_fp32_state_dict``:
    ``checkpoint_dir`` is a tag directory, or its parent with ``latest``
    (or ``tag``) naming one."""
    if tag is None:
        tag = read_latest(checkpoint_dir)
    if tag is not None and os.path.isdir(os.path.join(checkpoint_dir,
                                                      str(tag))):
        checkpoint_dir = os.path.join(checkpoint_dir, str(tag))
    state = consolidate_fp32_state(checkpoint_dir)
    save_tree(output_file, state)
    return state


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="zero_to_fp32",
        description="Consolidate a checkpoint into fp32 weights")
    parser.add_argument("checkpoint_dir",
                        help="checkpoint dir (tag dir or parent with 'latest')")
    parser.add_argument("output_file", help="where to write the fp32 weights")
    parser.add_argument("-t", "--tag", default=None,
                        help="checkpoint tag (default: read 'latest')")
    args = parser.parse_args(argv)
    state = convert_zero_checkpoint_to_fp32_state_dict(
        args.checkpoint_dir, args.output_file, tag=args.tag)
    n = sum(math.prod(v.shape) for v in _leaves(state) if hasattr(v, "shape"))
    print(f"wrote {args.output_file} ({n:,} fp32 elements)")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
