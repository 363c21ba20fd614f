"""YAML experiment options (counterpart of utils/options.py): the same
schema (name, model_type, datasets, network_g/d/d2, train, val, logger,
path), `--force_yml` overrides, the debug-mode frequencies, the seed, the
dataset phase bookkeeping, the experiment directory conventions and the
config snapshot.

Every option file and every `--force_yml` value is read by `load_yaml`,
PyYAML's `safe_load`, imported at first use.
"""

import argparse
import os
import os.path as osp
import random
import sys
import time


def load_yaml(stream):
    """The document in `stream` (text or a text file), by PyYAML's safe_load;
    ImportError naming the package where PyYAML is missing."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading option files needs PyYAML (the yaml package), "
                          "which is not installed") from e
    return yaml.safe_load(stream)


# --- options -------------------------------------------------------------------
def parse_options(root_path, is_train=True, args=None):
    """(opt, parsed argv) of the option file `--opt` with the command line's
    overrides. `--device` (the port's own flag) is `parsed.device`; it is
    not written into opt."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--opt", type=str, required=True,
                        help="Path to option YAML file.")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument(
        "--force_yml", nargs="+", default=None,
        help="Override yaml keys, e.g. train:total_iter=100")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parsed = parser.parse_args(args)

    with open(parsed.opt, "r") as f:
        opt = load_yaml(f)

    if parsed.force_yml is not None:
        for entry in parsed.force_yml:
            entry = entry.replace(" ", "")
            keys, value = entry.split("=", 1)
            node = opt
            key_list = keys.split(":")
            for k in key_list[:-1]:
                node = node.setdefault(k, {})
            node[key_list[-1]] = load_yaml(value)

    opt["auto_resume"] = parsed.auto_resume
    opt["is_train"] = is_train

    if parsed.debug and not opt["name"].startswith("debug"):
        opt["name"] = "debug_" + opt["name"]
    if opt["name"].startswith("debug"):
        opt.setdefault("val", {})
        opt["val"]["val_freq"] = 8
        opt.setdefault("logger", {})
        opt["logger"]["print_freq"] = 1
        opt["logger"]["save_checkpoint_freq"] = 8

    seed = parsed.seed if parsed.seed is not None else opt.get("manual_seed")
    if seed is None:
        seed = random.randint(1, 10000)
        opt["manual_seed"] = seed

    # dataset phase bookkeeping
    for phase, dataset in (opt.get("datasets") or {}).items():
        phase_key = phase.split("_")[0]
        dataset["phase"] = phase_key
        if "scale" in opt:
            dataset["scale"] = opt["scale"]

    # experiment directory conventions
    path_opt = opt.setdefault("path", {})
    if is_train:
        exp_root = path_opt.get("experiments_root") or osp.join(
            root_path, "experiments", opt["name"])
        path_opt["experiments_root"] = exp_root
        path_opt["models"] = osp.join(exp_root, "models")
        path_opt["training_states"] = osp.join(exp_root, "training_states")
        path_opt["log"] = exp_root
        path_opt["visualization"] = osp.join(exp_root, "visualization")
    else:
        results_root = path_opt.get("results_root") or osp.join(
            root_path, "results", opt["name"])
        path_opt["results_root"] = results_root
        path_opt["log"] = results_root
        path_opt["visualization"] = osp.join(results_root, "visualization")

    return opt, parsed


def copy_opt_file(opt_file, experiments_root):
    """Snapshot of the option file in the experiment directory, headed by
    the time and the command line."""
    import shutil
    os.makedirs(experiments_root, exist_ok=True)
    cmd = " ".join(sys.argv)
    filename = osp.join(experiments_root, osp.basename(opt_file))
    shutil.copyfile(opt_file, filename)
    with open(filename, "r+") as f:
        lines = f.readlines()
        lines.insert(0, f"# GENERATE TIME: {time.asctime()}\n# CMD:\n# {cmd}\n\n")
        f.seek(0)
        f.writelines(lines)


def make_exp_dirs(opt):
    path_opt = opt["path"]
    for key in ("experiments_root", "models", "training_states",
                "visualization", "results_root"):
        if key in path_opt and path_opt[key]:
            os.makedirs(path_opt[key], exist_ok=True)
