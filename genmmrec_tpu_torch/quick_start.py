"""Run orchestration (counterpart of ``genmmrec_tpu/quick_start.py``):
config merge → data → the hyper-parameter grid → train and evaluate →
the best result.

``quick_start`` merges the config tiers, logs the dataset, its splits and
the popular-item (top 20% of the train items by count) and warm-user (more
than 5 train interactions) groups, builds the train and eval tensors once
on ``device``, then runs each combination of ``Config.hyper_grid`` from
``init_seed``: ``get_model`` → ``get_trainer`` → ``fit``. It keeps the
best test result (by the valid metric) across the grid, logs the final
BEST block and returns that combination's (combo, best valid, test).

The device is the card unless the caller asks for the CPU: with no CUDA
device, ``device="cuda"`` raises.

A ``mesh_shape`` of more than one rank launches its ranks
(``parallel.launch.run``), each running this function on its device in the
process group, and returns global rank 0's result; only rank 0 writes the
log, checkpoints, top-k files and wandb.
"""

from __future__ import annotations

import json
import os
import platform
from logging import getLogger

import numpy as np
import torch
import torch.distributed as dist

from genmmrec_tpu_torch.config import Config
from genmmrec_tpu_torch.data.arrays import build_eval_data, build_train_data
from genmmrec_tpu_torch.data.dataset import RecDataset
from genmmrec_tpu_torch.engine.evaluator import group_masks
from genmmrec_tpu_torch.engine.trainer import get_trainer
from genmmrec_tpu_torch.models import get_model
from genmmrec_tpu_torch.parallel import launch
from genmmrec_tpu_torch.parallel.mesh import build_mesh, shape_dims
from genmmrec_tpu_torch.utils.logger import init_logger
from genmmrec_tpu_torch.utils.misc import dict2str, init_seed


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch finds no CUDA device; pass device='cpu' (--device cpu) "
            "to run on the CPU"
        )
    return device


def _wandb_init_for_combo(config, names, combo, logger):
    """A wandb run for one combination, named ``<model>_<dataset>_seed<seed>``
    plus ``_<name><value>`` for the other axes of a grid, with the config's
    JSON-serializable values (the rest as strings); None when ``use_wandb``
    is off or wandb is not installed."""
    if not bool(config["use_wandb"]) or (dist.is_initialized() and dist.get_rank() != 0):
        return None
    try:
        import wandb
    except ImportError:
        return None
    run_name = f"{config['model']}_{config['dataset']}_seed{config['seed']}"
    if len(combo) > 1:
        run_name += "_" + "_".join(f"{k}{v}" for k, v in zip(names[1:], combo[1:]))
    wandb_config = {}
    for k, v in config.final_config_dict.items():
        if callable(v):
            continue
        try:
            json.dumps(v)
            wandb_config[k] = v
        except (TypeError, ValueError):
            wandb_config[k] = str(v)
    run = wandb.init(
        project=str(config["wandb_project"] or "GenMMRec"),
        name=run_name,
        config=wandb_config,
        reinit=True,
        tags=[str(config["model"]), str(config["dataset"])],
        notes=f"Training {config['model']} on {config['dataset']}",
    )
    logger.info("W&B run initialized: %s", run_name)
    return run


def _quick_start_rank(device, *args):
    return quick_start(*args, device=device)


def quick_start(model, dataset, config_dict=None, save_model=True, mg=False, max_epochs=None, device="cuda"):
    device = resolve_device(device)
    config = Config(model, dataset, config_dict, mg)
    if max_epochs is not None:
        config["epochs"] = max_epochs
    if not dist.is_initialized() and config["mesh_shape"]:
        d, m = shape_dims(config["mesh_shape"])
        if d * m > 1:
            args = (model, dataset, config_dict, save_model, mg, max_epochs)
            return launch.run(_quick_start_rank, config["mesh_shape"], device, args)
    mesh = build_mesh(config)
    if mesh is not None and not mesh.member:
        return None
    init_logger(config, main=mesh is None or mesh.is_main)
    logger = getLogger()
    logger.info("██Server: \t" + platform.node())
    logger.info("██Dir: \t" + os.getcwd() + "\n")
    logger.info(config)

    ds = RecDataset(config)
    logger.info(str(ds))
    train_ds, valid_ds, test_ds = ds.split()
    logger.info("\n====Training====\n" + str(train_ds))
    logger.info("\n====Validation====\n" + str(valid_ds))
    logger.info("\n====Testing====\n" + str(test_ds))

    config["pop_mask"], config["warm_mask"] = group_masks(train_ds, device)
    n_items_seen = len(np.unique(train_ds.table.items))
    num_pop = int(config["pop_mask"].sum())
    logger.info(
        f"Train dataset All Interaction items count: {n_items_seen}, "
        f"Popular items count: {num_pop}, "
        f"Niche items count: {n_items_seen - num_pop}"
    )
    n_warm = int(config["warm_mask"].sum())
    n_active = len(np.unique(train_ds.table.users))
    logger.info("User Grouping based on Training History (Threshold=5):")
    logger.info(f"  Warm Users (>5 interactions): {n_warm}")
    logger.info(f"  Cold Users (<=5 interactions): {n_active - n_warm} (in training set)")

    train_data = build_train_data(train_ds, device)
    eval_bs = int(config["eval_batch_size"])
    valid_data = build_eval_data(valid_ds, train_ds, eval_bs, device)
    test_data = build_eval_data(test_ds, train_ds, eval_bs, device)

    logger.info("\n\n=================================\n\n")

    hyper_ret = []
    best_test_value = 0.0
    idx = best_test_idx = 0
    val_metric = str(config["valid_metric"]).lower()

    combos = list(config.hyper_grid())
    total = len(combos)
    for names, combo in combos:
        for name, value in zip(names, combo):
            config[name] = value
        init_seed(int(config["seed"]))
        logger.info("========={}/{}: Parameters:{}={}=======".format(idx + 1, total, names, combo))
        wandb_run = _wandb_init_for_combo(config, names, combo, logger)

        model_obj = get_model(config["model"])(config, train_data)
        trainer = get_trainer(config["model"])(config, model_obj, mg, mesh=mesh)
        best_valid_score, best_valid_result, best_test_upon_valid = trainer.fit(
            train_data, valid_data, test_data, saved=save_model
        )
        hyper_ret.append((combo, best_valid_result, best_test_upon_valid))

        if wandb_run is not None:
            import wandb

            wandb.log({
                "best_valid_score": best_valid_score,
                **{f"valid/{k}": v for k, v in best_valid_result.items()},
                **{f"test/{k}": v for k, v in best_test_upon_valid.items()},
            })
            wandb.run.summary.update({
                "best_valid_score": best_valid_score,
                **{f"final_valid_{k}": v for k, v in best_valid_result.items()},
                **{f"final_test_{k}": v for k, v in best_test_upon_valid.items()},
            })
            wandb.finish()

        if best_test_upon_valid.get(val_metric, 0.0) > best_test_value:
            best_test_value = best_test_upon_valid.get(val_metric, 0.0)
            best_test_idx = idx
        idx += 1

        logger.info("best valid result: {}".format(dict2str(best_valid_result)))
        logger.info("test result: {}".format(dict2str(best_test_upon_valid)))
        logger.info(
            "████Current BEST████:\nParameters: {}={},\nValid: {},\nTest: {}\n\n\n".format(
                names,
                hyper_ret[best_test_idx][0],
                dict2str(hyper_ret[best_test_idx][1]),
                dict2str(hyper_ret[best_test_idx][2]),
            )
        )

    logger.info("\n============All Over=====================")
    for p, best_valid, best_test in hyper_ret:
        logger.info(
            "Parameters: {}={},\n best valid: {},\n best test: {}".format(
                names, p, dict2str(best_valid), dict2str(best_test)
            )
        )
    logger.info("\n\n█████████████ BEST ████████████████")
    logger.info(
        "\tParameters: {}={},\nValid: {},\nTest: {}\n\n".format(
            names,
            hyper_ret[best_test_idx][0],
            dict2str(hyper_ret[best_test_idx][1]),
            dict2str(hyper_ret[best_test_idx][2]),
        )
    )
    return hyper_ret[best_test_idx]
