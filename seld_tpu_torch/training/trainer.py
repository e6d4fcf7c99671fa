"""Trainer: epoch loop, early stopping, four-role checkpointing, CSV logging,
periodic metric testing.

The port's counterpart of ``seld_tpu/training/trainer.py``, itself a mirror
of the reference training script (reference train.py:207-716):

- dataset load + normalization (train.py:226-424): the six pickles, or a
  ``.seldpak`` container (``training_predictors_path`` ending in
  ``.seldpak``), whose batches the C++ reader gathers out of its memory map
  and which are normalized one at a time from statistics streamed once;
- the epoch loop with early stopping: run while ``worse_epochs < patience or
  epoch < min_n_epochs`` (train.py:538), ``max_epochs`` a hard cap;
- per-epoch validation; StepLR with its floor (train.py:570-571);
- four checkpoint roles (``training/checkpoint.py::ROLES``): latest, best on
  validation, the previous best, best on test (train.py:577-616, 658-669),
  and resume from the latest, a file of the port or of the JAX Trainer
  (``training/checkpoint.py::checkpoint_format``): a model directory the
  JAX Trainer left resumes here;
- per-epoch ``<name>_training_metrics.csv`` row and per-test
  ``<name>_test_metrics.csv`` 16-column row (train.py:620-621, 634-643);
- a test every ``test_step`` epochs with ``test_mode='test_best'``: the
  best-so-far weights are evaluated, and the best Global SELD is kept
  (train.py:628-674);
- archive directories every ``checkpoint_step`` epochs (train.py:676-688);
- at the end: best-on-test reloaded, losses on every split,
  ``results_dict.json`` (true JSON), a final test (train.py:692-716).

Each epoch's line in ``metrics.jsonl`` also carries ``kernel_launches``: how
many times each kernel wrapper launched during that epoch's train steps
(``ops/kernels.launch_counts``; empty on the CPU).

One process trains on one device: ``device`` defaults to "cuda" and raises
without a card; the tests pass ``device="cpu"``. Under a process group
(``parallel/multihost.initialize``) the ranks form the data axis
(``mesh_data`` -1, or the world size; ``mesh_model > 1`` raises): every
loader yields this rank's rows of each global batch (the training loader
drops its remainder), the step computes the global batch's statistics and
averages the gradients (``training/steps.py``), the validation loss is the
global batch's, the metric pass runs on every rank's rows gathered onto each,
so every rank logs the same numbers, and rank 0 alone writes the files while
the others wait at a barrier.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from seld_tpu_torch.data.loader import (
    BatchIterator, load_task2_pickles, make_loaders, make_pak_loaders,
)
from seld_tpu_torch.data.normalize import (
    compute_norm_stats, make_batch_transform, normalize_dataset,
)
from seld_tpu_torch.metrics import (
    SELDMetrics, gen_submission_list_task2, location_sensitive_detection, segment_labels,
)
from seld_tpu_torch.models.seld import model_from_config
from seld_tpu_torch.ops.kernels import launch_counts
from seld_tpu_torch.parallel import multihost
from seld_tpu_torch.parallel.mesh import make_mesh
from seld_tpu_torch.training.checkpoint import (
    ROLES, archive_checkpoints, checkpoint_format, load_checkpoint, save_checkpoint,
)
from seld_tpu_torch.training.loss import seld_loss
from seld_tpu_torch.training.schedule import schedule_from_config
from seld_tpu_torch.training.steps import (
    TrainState, create_train_state, make_infer_step, make_optimizer, make_train_step,
    set_learning_rate,
)
from seld_tpu_torch.utils.io import save_array_to_csv
from seld_tpu_torch.utils.profiling import MetricsLogger, StepTimer
from seld_tpu_torch.utils.summary import describe_model_name, model_summary


def evaluate_test_outputs(sed: np.ndarray, doa: np.ndarray, target: np.ndarray,
                          eval_metrics: SELDMetrics, cfg) -> tuple:
    """Per-clip metric update; returns (tp, fp, fn). Mirrors train.py:96-127."""
    n_sed = int(cfg.output_classes * cfg.class_overlaps)
    kw = dict(max_overlaps=int(cfg.class_overlaps), max_loc_value=cfg.max_loc_value,
              num_classes=cfg.output_classes)
    prediction, prediction_dict = gen_submission_list_task2(sed, doa, **kw)
    truth, truth_dict = gen_submission_list_task2(target[:, :n_sed], target[:, n_sed:], **kw)
    eval_metrics.update_seld_scores(segment_labels(prediction_dict, cfg.num_frames),
                                    segment_labels(truth_dict, cfg.num_frames))
    tp, fp, fn, _ = location_sensitive_detection(prediction, truth, cfg.num_frames,
                                                 cfg.spatial_threshold, False)
    return tp, fp, fn


class Trainer:
    """Config-driven trainer (the ``python -m seld_tpu_torch.train
    --TextArgs=...`` engine) on one device a process."""

    def __init__(self, cfg, verbose: bool = True, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device='cpu' to train on the CPU")
        self.rank, self.n_hosts = multihost.process_info()
        mesh = make_mesh(cfg.mesh_data, max(1, cfg.mesh_model))
        self.mesh = mesh if mesh.n_data > 1 else None
        self.cfg = cfg
        self.verbose = verbose
        self.np_rng = np.random.default_rng(1 if cfg.fixed_seed else None)
        self.model = None
        self._log_fn = print if verbose else (lambda *a, **k: None)

    def _log(self, *args):
        self._log_fn(*args)

    # ------------------------------------------------------------------ setup
    def setup_data(self):
        cfg = self.cfg
        shard = dict(num_shards=self.n_hosts, shard_id=self.rank)
        norm = dict(mode=cfg.dataset_normalization, n_mics=cfg.n_mics, phase=cfg.phase,
                    domain=cfg.domain)
        if str(cfg.training_predictors_path).endswith(".seldpak"):
            # the splits stay in the memory map: each batch is gathered by the
            # C++ reader and normalized from its split's statistics, streamed once
            from seld_tpu_torch.data.native import PakReader

            self._pak_reader = reader = PakReader(cfg.training_predictors_path)
            transforms = {split: make_batch_transform(
                stats=compute_norm_stats(reader.split(split)[0], **norm), **norm)
                for split in ("train", "val", "test")}
            self.loaders = make_pak_loaders(reader, cfg.batch_size, seed=1,
                                            transforms=transforms, **shard)
            test_shape = reader.shape(reader.SPLITS["test"][0])
        else:
            predictors, targets = load_task2_pickles(cfg)
            predictors = normalize_dataset(predictors, **norm)
            self.loaders = make_loaders(predictors, targets, cfg.batch_size, seed=1, **shard)
            test_shape = predictors["test"].shape
        if self.mesh is not None:
            self.loaders["train"].drop_last = True
        self.n_time_frames = test_shape[-1]

    def setup_model(self, seed: int = 0):
        """The model from the config, with weights drawn from a CPU generator
        seeded ``seed``, Adam, the steps and the LR schedule. Every topology
        of the JAX package builds: one trunk or the 2Parallel / magnitude +
        phase trunks, with or without the SE block; each trunk's CNN stages
        take the kernels their conditions allow (``models/blocks.py``)."""
        cfg = self.cfg
        self.model = model_from_config(cfg, device=self.device,
                                       generator=torch.Generator().manual_seed(seed))
        self.state = create_train_state(
            self.model, cfg, torch.Generator(device=self.device).manual_seed(seed))
        if self.mesh is not None:   # every rank starts from rank 0's weights
            from seld_tpu_torch.parallel.dp_step import replicate_state

            replicate_state(self.state, self.mesh)
        self.train_step = make_train_step(cfg, self.mesh)
        self.infer_step = make_infer_step(cfg)
        self.sched = schedule_from_config(cfg)
        self.n_params = sum(p.numel() for p in self.model.parameters())
        self._log(f"Model: {self.model.model_name}")
        rf, n_rb = self.model.receptive_field()
        self._log(f"Receptive Field: {rf}  ResBlocks: {n_rb}")
        self._log(f"Total parameters: {self.n_params}")
        if self.verbose:
            for line in describe_model_name(self.model.model_name):
                self._log("  " + line)
            self._log(model_summary(self.model, depth=2))

    # ------------------------------------------------------------- primitives
    def _device_batch(self, x, y):
        """(x, y, sharded): this rank's rows on the device, or under a mesh
        the whole global batch where it does not split (``sharded`` False;
        ``multihost.global_batch``)."""
        if self.mesh is not None:
            (x, y), sharded = multihost.global_batch(
                self.mesh, np.asarray(x, np.float32), np.asarray(y, np.float32),
                device=self.device)
            return x, y, sharded
        to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(self.device)
        return to(x), to(y), True

    def _sync(self, name: str) -> None:
        """Under a mesh, wait for rank 0's writes before anyone reads them."""
        if self.mesh is not None:
            multihost.barrier(name)

    def _weights_of(self, path: str) -> tuple:
        """The checkpoint at ``path`` (either format) loaded into a state that
        shares the model (its weights are replaced) with an optimizer and
        generator of its own; returns (state, loop_state)."""
        state = TrainState(self.model, make_optimizer(self.model.parameters(), self.cfg.lr),
                           torch.Generator(device=self.device))
        state, loop, _ = load_checkpoint(path, state)
        return state, loop

    def evaluate(self, loader: BatchIterator) -> float:
        """Mean per-batch loss (the reference's running mean == batch mean)."""
        cfg = self.cfg
        losses = []
        for x, y in loader:
            x, y, _ = self._device_batch(x, y)
            sed, doa = self.infer_step(self.model, x)
            loss = seld_loss(sed, doa, y, output_classes=cfg.output_classes,
                             class_overlaps=int(cfg.class_overlaps),
                             sed_weight=cfg.sed_loss_weight, doa_weight=cfg.doa_loss_weight)
            if self.mesh is not None:   # the global batch's: the ranks' losses by rows
                n = x.shape[0]
                tot = self.mesh.cross_rank.sum(torch.tensor(
                    [float(loss) * n, n], dtype=torch.float64, device=self.device), "eval")
                loss = tot[0] / tot[1]
            losses.append(float(loss))
        return float(np.mean(losses)) if losses else float("nan")

    def evaluate_test(self, loader: BatchIterator, epoch: int = 0) -> List[float]:
        """Full metric pass; returns the 16-column results row (train.py:146-148)."""
        cfg = self.cfg
        TP = FP = FN = 0
        eval_metrics = SELDMetrics(nb_classes=cfg.output_classes,
                                   doa_threshold=cfg.Dcase21_metrics_DOA_threshold)
        for x, y in loader:
            xb, _, sharded = self._device_batch(x, y)
            sed, doa = (a.float().cpu().numpy() for a in self.infer_step(self.model, xb))
            if self.mesh is not None:   # every rank scores the global batch alike
                if sharded:
                    sed, doa = multihost.allgather_rows(sed), multihost.allgather_rows(doa)
                y = multihost.allgather_rows(np.asarray(y))
            for b in range(sed.shape[0]):
                tp, fp, fn = evaluate_test_outputs(sed[b], doa[b], np.asarray(y[b]),
                                                   eval_metrics, cfg)
                TP += tp
                FP += fp
                FN += fn
        eps = sys.float_info.epsilon
        precision = TP / (TP + FP + eps)
        recall = TP / (TP + FN + eps)
        F_score = 2 * precision * recall / (precision + recall + eps)
        Nref, Nsys = TP + FN, TP + FP
        ER_score = (max(Nref, Nsys) - TP) / (Nref + 0.0) if Nref else 0.0
        ER_d, F_d, LE_d, LR_d = eval_metrics.compute_seld_scores()
        SELD_dcase21 = float(np.mean([ER_d, 1 - F_d, LE_d / 180, 1 - LR_d]))
        Global_SELD = float(np.mean([ER_score, 1 - F_score, LE_d / 180, 1 - LR_d]))
        CSL = float(np.mean([LE_d / 180, 1 - LR_d]))
        LSD = float(np.mean([1 - F_score, ER_score]))
        self._log(f"TEST epoch {epoch}: Global SELD {Global_SELD:.4f} LSD {LSD:.4f} "
                  f"CSL {CSL:.4f} F {F_score:.4f} ER {ER_score:.4f} LE {LE_d:.2f} "
                  f"LR {LR_d:.4f}")
        return [epoch, F_score, ER_score, precision, recall, TP, FP, FN,
                CSL, LSD, Global_SELD, SELD_dcase21, ER_d, F_d, LE_d, LR_d]

    # ------------------------------------------------------------------ train
    def fit(self, max_epochs: Optional[int] = None) -> Dict:
        cfg = self.cfg
        name = self.model.model_name + cfg.model_extra_name
        model_dir = os.path.join("RESULTS_Original", "Task2", cfg.architecture, name)
        os.makedirs(model_dir, exist_ok=True)
        unique_name = os.path.join(model_dir, name)
        path = {role: os.path.join(model_dir, f) for role, f in ROLES.items()}
        ckpt, ckpt_best = path["checkpoint"], path["checkpoint_best"]
        ckpt_best_backup = path["checkpoint_best_model_checkpoint"]
        ckpt_best_test = path["checkpoint_best_model_on_Test"]

        loop = {"step": 0, "worse_epochs": 0, "epochs": 0, "best_loss": float("inf"),
                "best_epoch": 0, "best_test_epoch": 0}
        epoch = 0
        best_loss_checkpoint = float("inf")
        best_epoch_checkpoint = 0
        best_test_metric = 1.0
        new_best = False
        train_hist: List[float] = []
        val_hist: List[float] = []

        # auto-resume from the latest checkpoint, like train.py:467,525-528
        if os.path.isfile(ckpt):
            self._log(f"Resuming from {ckpt} ({checkpoint_format(ckpt)} checkpoint)")
            self.state, loop, sched = load_checkpoint(ckpt, self.state, self.np_rng)
            if sched is not None:
                self.sched = sched
            epoch = loop["epochs"]

        metrics_log = MetricsLogger(os.path.join(model_dir, "metrics.jsonl"))
        step_timer = StepTimer(warmup_steps=2, device=self.device)
        self._log("TRAINING START")
        while loop["worse_epochs"] < cfg.patience or epoch < cfg.min_n_epochs:
            if max_epochs is not None and epoch >= max_epochs:
                break
            epoch += 1
            loop["epochs"] += 1
            self.loaders["train"].set_epoch(epoch)
            lr = self.sched.lr
            set_learning_rate(self.state, lr)
            self._log(f"Epoch {epoch} lr={lr:.6g}")
            t0 = time.time()
            launches0 = dict(launch_counts)
            batch_losses = []
            for x, y in self.loaders["train"]:
                x, y, sharded = self._device_batch(x, y)
                with step_timer:
                    self.state, loss = self.train_step(self.state, x, y, sharded)
                batch_losses.append(loss)
                loop["step"] += 1
            launches = {k: v - launches0[k] for k, v in launch_counts.items() if v > launches0[k]}
            train_loss = float(np.mean([float(v) for v in batch_losses]))
            val_loss = self.evaluate(self.loaders["val"])
            self.sched = self.sched.epoch_step()
            train_hist.append(train_loss)
            val_hist.append(val_loss)
            self._log(f"epoch {epoch}: train {train_loss:.4f} val {val_loss:.4f} "
                      f"({time.time() - t0:.1f}s)")
            if self.rank == 0:
                metrics_log.log(loop["step"], epoch=epoch, train_loss=train_loss,
                                val_loss=val_loss, lr=lr, **step_timer.summary(),
                                kernel_launches=launches)

            # early-stopping bookkeeping + 4-role checkpointing (train.py:588-616)
            if val_loss >= loop["best_loss"]:
                loop["worse_epochs"] += 1
            else:
                if new_best:
                    best_loss_checkpoint = loop["best_loss"]
                    best_epoch_checkpoint = loop["best_epoch"]
                    if self.rank == 0 and os.path.exists(ckpt_best):
                        shutil.copyfile(ckpt_best, ckpt_best_backup)
                self._log("MODEL IMPROVED ON VALIDATION SET!")
                loop["worse_epochs"] = 0
                loop["best_loss"] = val_loss
                loop["best_epoch"] = epoch
                new_best = True
                if self.rank == 0:
                    save_checkpoint(ckpt_best, self.state, loop, self.sched, self.np_rng)
            if val_loss < best_loss_checkpoint and (
                    val_loss != loop["best_loss"] or best_loss_checkpoint == float("inf")):
                best_loss_checkpoint = val_loss
                best_epoch_checkpoint = epoch
                if self.rank == 0:
                    save_checkpoint(ckpt_best_backup, self.state, loop, self.sched,
                                    self.np_rng)
            if self.rank == 0:
                save_checkpoint(ckpt, self.state, loop, self.sched, self.np_rng)
                save_array_to_csv(f"{unique_name}_training_metrics.csv",
                                  [epoch, train_loss, val_loss])
            self._sync(f"checkpoints of epoch {epoch}")

            # periodic test (train.py:628-674)
            if epoch % cfg.test_step == 0:
                tested, current = self.state, None
                if cfg.test_mode == "test_best":
                    src = ckpt_best if new_best else ckpt_best_backup
                    test_epoch = loop["best_epoch"] if new_best else best_epoch_checkpoint
                    if os.path.exists(src):
                        current = {k: v.detach().clone()
                                   for k, v in self.model.state_dict().items()}
                        tested, _ = self._weights_of(src)
                else:
                    test_epoch = epoch
                results_row = self.evaluate_test(self.loaders["test"], epoch=test_epoch)
                if self.rank == 0:
                    save_array_to_csv(f"{unique_name}_test_metrics.csv", results_row)
                if results_row[10] <= best_test_metric:
                    self._log("Saving BEST TEST model...")
                    best_test_metric = results_row[10]
                    loop["best_test_epoch"] = test_epoch
                    if self.rank == 0:
                        save_checkpoint(ckpt_best_test, tested, loop, self.sched, self.np_rng)
                if current is not None:
                    self.model.load_state_dict(current)
                new_best = False

            if epoch % cfg.checkpoint_step == 0 and self.rank == 0:
                archive_checkpoints(model_dir, epoch, {
                    "checkpoint_best": ckpt_best, "checkpoint": ckpt,
                    "checkpoint_best_model_on_Test": ckpt_best_test,
                    "checkpoint_best_model_checkpoint": ckpt_best_backup,
                })
            self._sync(f"tests and archives of epoch {epoch}")

        # final: reload best-on-test and evaluate everything (train.py:692-716)
        self._log("TESTING")
        final_src = ckpt_best_test if os.path.exists(ckpt_best_test) else ckpt
        _, loop_final = self._weights_of(final_src)
        results = {
            "train_loss": self.evaluate(self.loaders["train"]),
            "val_loss": self.evaluate(self.loaders["val"]),
            "test_loss": self.evaluate(self.loaders["test"]),
            "train_loss_hist": train_hist,
            "val_loss_hist": val_hist,
        }
        if self.rank == 0:
            os.makedirs(cfg.results_path, exist_ok=True)
            with open(os.path.join(cfg.results_path, "results_dict.json"), "w") as f:
                json.dump(results, f, indent=2)
        results["final_test"] = self.evaluate_test(
            self.loaders["test"], epoch=loop_final.get("best_test_epoch", 0))
        return results

    def run(self, max_epochs: Optional[int] = None) -> Dict:
        self.setup_data()
        self.setup_model()
        return self.fit(max_epochs=max_epochs)
