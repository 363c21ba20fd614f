"""Logging (counterpart of utils/logger.py): the root logger, the
iteration and data timers, the training message line
`[name..][epoch, iter, lr] [eta, time (data)] l_*: ...` mirrored to
tensorboard, and the optional wandb sync. The port trains on one card in
one process, rank 0, which logs (JAX gates on `jax.process_index()`)."""

import datetime
import logging
import time

_initialized_loggers = {}


def get_root_logger(logger_name="ood_gan_inversion_tpu_torch", log_level=logging.INFO,
                    log_file=None):
    logger = logging.getLogger(logger_name)
    if logger_name in _initialized_loggers:
        return logger
    fmt = "%(asctime)s %(levelname)s: %(message)s"
    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter(fmt))
    logger.addHandler(sh)
    logger.propagate = False
    logger.setLevel(log_level)
    if log_file is not None:
        fh = logging.FileHandler(log_file, "w")
        fh.setFormatter(logging.Formatter(fmt))
        logger.addHandler(fh)
    _initialized_loggers[logger_name] = True
    return logger


class AvgTimer:
    """Host-clock seconds between `start` (or the last `record`) and
    `record`, averaged over a window of records."""

    def __init__(self, window=200):
        self.window = window
        self.current_time = 0
        self.total_time = 0
        self.count = 0
        self.avg_time = 0
        self.start()

    def start(self):
        self.start_time = self.tic = time.time()

    def record(self):
        self.count += 1
        self.toc = time.time()
        self.current_time = self.toc - self.tic
        self.total_time += self.current_time
        self.avg_time = self.total_time / self.count
        if self.count > self.window:
            self.count = 0
            self.total_time = 0
        self.tic = time.time()

    def get_avg_time(self):
        return self.avg_time


def init_tb_logger(log_dir):
    """A tensorboard SummaryWriter, or None where tensorboard is not
    installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(log_dir=log_dir)
    except ImportError:
        get_root_logger().warning("tensorboard is not installed; use_tb_logger is ignored")
        return None


class MessageLogger:
    def __init__(self, opt, start_iter=1, tb_logger=None):
        self.exp_name = opt["name"]
        logger_opt = opt.get("logger", {}) or {}
        self.start_iter = start_iter
        self.max_iters = opt.get("train", {}).get("total_iter", 0)
        self.use_tb_logger = logger_opt.get("use_tb_logger", False)
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def __call__(self, log_vars: dict):
        current_iter = log_vars.pop("iter")
        epoch = log_vars.pop("epoch", 0)
        lrs = log_vars.pop("lrs", [])
        message = (f"[{self.exp_name[:5]}..][epoch:{epoch:3d}, "
                   f"iter:{current_iter:8,d}, lr:(")
        message += ",".join(f"{v:.3e}" for v in lrs) + ")] "

        if "time" in log_vars:
            iter_time = log_vars.pop("time")
            data_time = log_vars.pop("data_time", 0)
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / max(current_iter - self.start_iter + 1, 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(max(eta_sec, 0))))
            message += f"[eta: {eta_str}, time (data): {iter_time:.3f} ({data_time:.3f})] "

        for k, v in log_vars.items():
            message += f"{k}: {float(v):.4e} "
            if self.tb_logger and self.use_tb_logger:
                key = f"losses/{k}" if k.startswith("l_") else k
                self.tb_logger.add_scalar(key, float(v), current_iter)
        self.logger.info(message)


def init_wandb_logger(opt):
    """wandb in tensorboard-sync mode; a no-op with a warning where the
    wandb package is not installed."""
    try:
        import wandb
    except ImportError:
        get_root_logger().warning(
            "wandb requested but not installed; skipping (tb still active)")
        return None
    wandb_opt = (opt.get("logger", {}) or {}).get("wandb", {}) or {}
    project = wandb_opt.get("project")
    if not project:
        return None
    resume_id = wandb_opt.get("resume_id")
    kwargs = {"id": resume_id, "resume": "allow"} if resume_id else {}
    wandb.init(project=project, name=opt["name"], sync_tensorboard=True,
               config=opt, **kwargs)
    return wandb
