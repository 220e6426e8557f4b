"""`python -m deeperspeed_tpu_torch.elasticity`: the `ds_elastic` CLI.

Counterpart of deeperspeed_tpu/elasticity/__main__.py: print a config's
elasticity block and, given a world size, the resolved batch
configuration."""

import argparse
import json

from .elasticity import compute_elastic_config


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ds_elastic")
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="DeepSpeed config json")
    parser.add_argument("-w", "--world-size", type=int, default=0,
                        help="Intended/current world size")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        ds_config = json.load(f)

    sep = "-" * 42
    print(sep)
    print("Elasticity config:")
    print(sep)
    print(json.dumps(ds_config["elasticity"], indent=4, sort_keys=True))

    if args.world_size > 0:
        final_batch, valid_chips, micro = compute_elastic_config(
            ds_config=ds_config, target_deepspeed_version=None,
            world_size=args.world_size,
        )
        print(sep)
        print(f"Calculated results for world size {args.world_size}:")
        print(sep)
        print(f"final_batch_size .... {final_batch}")
        print(f"valid_chips ......... {valid_chips}")
        print(f"micro_batch_size .... {micro}")
    else:
        final_batch, valid_chips = compute_elastic_config(
            ds_config=ds_config, target_deepspeed_version=None,
        )
        print(sep)
        print("Calculated results:")
        print(sep)
        print(f"final_batch_size .... {final_batch}")
        print(f"valid_chips ......... {valid_chips}")


if __name__ == "__main__":
    main()
