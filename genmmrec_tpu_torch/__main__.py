"""Command line of the port (counterpart of ``main.py``):

    python -m genmmrec_tpu_torch --model FREEDOM --dataset baby [--mg] [--epochs N]
        [--config-json '{"eval_dtype": "bfloat16"}' | --config-json overrides.json] [--device cuda|cpu]

It runs ``quick_start`` on the card (``--device cuda``, the default; an
error without one) or, when asked, on the CPU. Its last line on standard
output, ``RUN_TAG`` and a JSON object, gives the device, each kernel's
launches (``ops.launch_counts``) and the card's peak allocated memory (null
on the CPU), which the experiment harnesses under ``scripts/`` read."""

import argparse
import json

import torch

from genmmrec_tpu_torch.ops import launch_counts
from genmmrec_tpu_torch.quick_start import quick_start

RUN_TAG = "genmmrec_tpu_torch run "


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m genmmrec_tpu_torch")
    parser.add_argument("--model", "-m", type=str, default="DiffMM", help="name of models")
    parser.add_argument("--dataset", "-d", type=str, default="baby", help="name of datasets")
    parser.add_argument("--mg", action="store_true", help="mirror-gradient training")
    parser.add_argument("--epochs", type=int, default=None, help="override epoch count")
    parser.add_argument(
        "--config-json", type=str, default=None,
        help="config overrides: inline JSON dict or a path to a JSON file",
    )
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args, _ = parser.parse_known_args(argv)

    config_dict = {}
    if args.config_json:
        if args.config_json.lstrip().startswith("{"):
            config_dict.update(json.loads(args.config_json))
        else:
            with open(args.config_json) as f:
                config_dict.update(json.load(f))
    quick_start(
        model=args.model,
        dataset=args.dataset,
        config_dict=config_dict,
        save_model=True,
        mg=args.mg,
        max_epochs=args.epochs,
        device=args.device,
    )
    on_card = torch.device(args.device).type == "cuda"
    print(RUN_TAG + json.dumps(dict(
        device=torch.cuda.get_device_name(0) if on_card else args.device,
        launches=launch_counts(),
        peak_allocated_bytes=torch.cuda.max_memory_allocated() if on_card else None,
    )), flush=True)


if __name__ == "__main__":
    main()
