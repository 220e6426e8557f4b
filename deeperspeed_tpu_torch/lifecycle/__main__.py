"""Operator CLI for the lifecycle control plane.

Counterpart of ``python -m deeperspeed_tpu.lifecycle``, with the same verbs
and files::

    python -m deeperspeed_tpu_torch.lifecycle versions --ckpt-dir CKPTS
    python -m deeperspeed_tpu_torch.lifecycle publish  --ckpt-dir CKPTS [--tag T]
    python -m deeperspeed_tpu_torch.lifecycle retire   --ckpt-dir CKPTS --version N
    python -m deeperspeed_tpu_torch.lifecycle pool     --pool-file F --size N

``versions`` prints the registry; ``publish`` turns a COMMITTED tag
(default: whatever ``latest`` points at) into the next weight version;
``retire`` takes a version out of rotation; ``pool`` atomically rewrites
the pool file the supervisor watches: the operator-facing way to trigger
a live re-mesh on a running trainer.

The verbs themselves use the standard library only (the registry and the
``latest`` pointer are JSON and text files).
"""

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from .versions import VersionRegistry


def _cmd_versions(args) -> int:
    reg = VersionRegistry(args.ckpt_dir)
    recs = reg.list()
    print(json.dumps({"versions": [r.to_dict() for r in recs]}, indent=1))
    return 0


def _cmd_publish(args) -> int:
    from ..checkpoint.serialization import read_latest

    tag = args.tag or read_latest(args.ckpt_dir)
    if not tag:
        print("publish: no --tag given and no `latest` pointer in "
              f"{args.ckpt_dir}", file=sys.stderr)
        return 2
    reg = VersionRegistry(args.ckpt_dir, keep_live=args.keep_live)
    try:
        rec = reg.publish(tag)
    except ValueError as e:
        print(f"publish: {e}", file=sys.stderr)
        return 1
    print(json.dumps(rec.to_dict()))
    return 0


def _cmd_retire(args) -> int:
    reg = VersionRegistry(args.ckpt_dir)
    if not reg.retire(args.version):
        print(f"retire: no live version {args.version} in "
              f"{reg.path}", file=sys.stderr)
        return 1
    print(json.dumps({"retired": args.version}))
    return 0


def _cmd_pool(args) -> int:
    # same atomic rewrite discipline as every other control file: the
    # supervisor's watcher must never read a torn value
    pool_dir = os.path.dirname(args.pool_file)
    if pool_dir:
        os.makedirs(pool_dir, exist_ok=True)
    tmp = args.pool_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(int(args.size)) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, args.pool_file)
    print(json.dumps({"pool_file": args.pool_file, "size": int(args.size)}))
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeperspeed_tpu_torch.lifecycle",
        description="train->serve lifecycle control plane")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("versions", help="print the weight-version registry")
    p.add_argument("--ckpt-dir", required=True)
    p.set_defaults(fn=_cmd_versions)

    p = sub.add_parser("publish",
                       help="publish a COMMITTED tag as the next version")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--tag", default=None,
                   help="checkpoint tag (default: the `latest` pointer)")
    p.add_argument("--keep-live", type=int, default=2)
    p.set_defaults(fn=_cmd_publish)

    p = sub.add_parser("retire", help="take a version out of rotation")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--version", type=int, required=True)
    p.set_defaults(fn=_cmd_retire)

    p = sub.add_parser("pool",
                       help="atomically rewrite the watched pool file")
    p.add_argument("--pool-file", required=True)
    p.add_argument("--size", type=int, required=True)
    p.set_defaults(fn=_cmd_pool)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
