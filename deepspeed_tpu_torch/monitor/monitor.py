"""Metrics monitors.

Port of ``deepspeed_tpu/monitor/monitor.py`` (reference ``deepspeed/monitor/``:
``Monitor`` ABC :13, ``MonitorMaster`` :29, TensorBoard/WandB/csv backends),
rank-0-gated by the ``torch.distributed`` rank (0 without a process group).
The CSV backend always works; TensorBoard and wandb only where their package
imports, and turn themselves off with a warning where it does not.
"""

import os
from abc import ABC, abstractmethod

from ..telemetry.sink import process_rank
from ..utils.logging import logger


class Monitor(ABC):

    def __init__(self, monitor_config):
        self.monitor_config = monitor_config

    @abstractmethod
    def write_events(self, event_list):
        ...


class csvMonitor(Monitor):

    def __init__(self, csv_config):
        super().__init__(csv_config)
        self.filenames = {}
        self.enabled = csv_config.enabled
        self.output_path = csv_config.output_path or "csv_monitor_output"
        self.job_name = csv_config.job_name

    def _file(self, name):
        if name not in self.filenames:
            path = os.path.join(self.output_path, self.job_name)
            os.makedirs(path, exist_ok=True)
            fname = os.path.join(path, "".join(c if (c.isalnum() or c in "._-") else "_" for c in name) + ".csv")
            self.filenames[name] = fname
        return self.filenames[name]

    def write_events(self, event_list):
        if not self.enabled or process_rank() != 0:
            return
        # group by metric so each csv file is opened once per call, not once
        # per event
        by_file = {}
        for event in event_list:
            name, value, step = event[0], event[1], event[2]
            by_file.setdefault(self._file(name), []).append(f"{step},{value}\n")
        for fname, lines in by_file.items():
            with open(fname, "a") as f:
                f.writelines(lines)


class TensorBoardMonitor(Monitor):

    def __init__(self, tensorboard_config):
        super().__init__(tensorboard_config)
        self.enabled = tensorboard_config.enabled
        self.summary_writer = None
        if self.enabled and process_rank() == 0:
            output_path = os.path.join(tensorboard_config.output_path or "tensorboard_output",
                                       tensorboard_config.job_name)
            try:
                from torch.utils.tensorboard import SummaryWriter
                os.makedirs(output_path, exist_ok=True)
                self.summary_writer = SummaryWriter(log_dir=output_path)
            except Exception as e:
                logger.warning(f"TensorBoard monitor disabled (writer unavailable: {e})")
                self.enabled = False

    def write_events(self, event_list, flush=True):
        if self.summary_writer is None:
            return
        for event in event_list:
            self.summary_writer.add_scalar(*event)
        if flush:
            self.summary_writer.flush()


class WandbMonitor(Monitor):

    def __init__(self, wandb_config):
        super().__init__(wandb_config)
        self.enabled = wandb_config.enabled
        if self.enabled and process_rank() == 0:
            try:
                import wandb
                wandb.init(project=wandb_config.project, group=wandb_config.group, entity=wandb_config.team)
                self._wandb = wandb
            except Exception as e:
                logger.warning(f"wandb monitor disabled ({e})")
                self.enabled = False

    def write_events(self, event_list):
        if not self.enabled or process_rank() != 0:
            return
        for event in event_list:
            label, value, step = event[0], event[1], event[2]
            self._wandb.log({label: value}, step=step)


class MonitorMaster(Monitor):
    """Dispatches to every enabled backend (reference ``monitor.py:29``)."""

    def __init__(self, ds_config):
        self.tb_monitor = None
        self.wandb_monitor = None
        self.csv_monitor = None
        self.enabled = False
        if process_rank() == 0:
            if ds_config.tensorboard.enabled:
                self.tb_monitor = TensorBoardMonitor(ds_config.tensorboard)
                self.enabled = True
            if ds_config.wandb.enabled:
                self.wandb_monitor = WandbMonitor(ds_config.wandb)
                self.enabled = True
            if ds_config.csv_monitor.enabled:
                self.csv_monitor = csvMonitor(ds_config.csv_monitor)
                self.enabled = True

    def write_events(self, event_list):
        if process_rank() != 0:
            return
        if self.tb_monitor is not None:
            self.tb_monitor.write_events(event_list)
        if self.wandb_monitor is not None:
            self.wandb_monitor.write_events(event_list)
        if self.csv_monitor is not None:
            self.csv_monitor.write_events(event_list)
