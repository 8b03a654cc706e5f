"""Viewport-prediction results recorder.

Port of the JAX package's ``utils/results.py`` (``:43-114``; reference
``viewport_prediction/utils/results.py:53-152``): per sample and horizon the
periodic MSE and the tile-IoU accuracy, recall, precision and f1, computed
for a whole batch by K7's metrics mode (``kernels/tile_occupancy.py:
trajectory_metrics``).  The output files keep the exact CSV, ``.log`` and
``accuracy_result.csv`` layouts, including the ``.log`` quirk of printing
``accuracy=None`` (the reference's always-None ``prob``) and the recall in
its place (``results.py:121-122``), and the cumulative-mean table.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.kernels.tile_occupancy import trajectory_metrics
from mansy_immersivevideostreaming_torch.utils.logging import ascii_table


class Results:
    def __init__(self, model_name: str, fut_window: int, output_dir: str,
                 dataset_frequency: int):
        self.model_name = model_name
        self.fut_window = fut_window
        self.output_dir = output_dir
        self.dataset_frequency = dataset_frequency
        self._rows: List[tuple] = []  # (video, user, timestamp, gt, pred, metrics)
        self.accuracy_per_horizon: List[List[float]] = [[] for _ in range(fut_window)]

    def record(self, prediction: torch.Tensor, ground_truth: torch.Tensor, video, user,
               timestamp) -> None:
        """Record a batch: ``prediction`` and ``ground_truth`` [B, F, 2] on one
        device (K7 runs there), the ids as numpy arrays."""
        mse, acc, rec, prec, f1 = (m.cpu().numpy() for m in trajectory_metrics(
            ground_truth.contiguous(), prediction.contiguous()))
        pred_np, gt_np = prediction.cpu().numpy(), ground_truth.cpu().numpy()
        video, user, timestamp = np.asarray(video), np.asarray(user), np.asarray(timestamp)
        for i in range(pred_np.shape[0]):
            self._rows.append((int(video[i]), int(user[i]), int(timestamp[i]),
                               gt_np[i], pred_np[i],
                               mse[i], acc[i], rec[i], prec[i], f1[i]))
            for t in range(self.fut_window):
                self.accuracy_per_horizon[t].append(float(acc[i, t]))

    def write(self, log: bool = True, label: str = "") -> None:
        os.makedirs(self.output_dir, exist_ok=True)
        csv_path = os.path.join(self.output_dir, label + "results.csv")
        with open(csv_path, "w", encoding="utf-8") as f:
            f.write("video,user,timestamp,time,gt_1,gt_2,pred_1,pred_2,"
                    "mse,accuracy,recall,precision,f1\n")
            for (video, user, ts, gt, pred, mse, acc, rec, prec, f1) in self._rows:
                for t in range(self.fut_window):
                    tt = round((t + 1) * (1 / self.dataset_frequency), 3)
                    f.write(f"{video},{user},{ts},{tt},{gt[t][0]},{gt[t][1]},"
                            f"{pred[t][0]},{pred[t][1]},{mse[t]},{acc[t]},"
                            f"{rec[t]},{prec[t]},{f1[t]}\n")
        print("Results saved at", csv_path)
        if log:
            log_path = os.path.join(self.output_dir, label + "results.log")
            with open(log_path, "w", encoding="utf-8") as f:
                for (video, user, ts, gt, pred, mse, acc, rec, prec, f1) in self._rows:
                    f.write(f"##### Video={video}, User={user}, Timestamp={ts} #####\n")
                    for t in range(self.fut_window):
                        tt = round((t + 1) * (1 / self.dataset_frequency), 3)
                        # preserved quirk: reference results.py:121-122 prints
                        # prob (None) as 'accuracy' and recall twice
                        f.write(f"time={tt}, gt={list(gt[t])}, pred={list(pred[t])}, "
                                f"mse={mse[t]}, accuracy=None, "
                                f"recall={rec[t]}, precision={prec[t]}, f1={f1[t]}\n")
            print("Log saved at", log_path)

        accuracy_csv_path = os.path.join(self.output_dir, label + "accuracy_result.csv")
        mean_acc = [float(np.mean(a)) * 100.0 for a in self.accuracy_per_horizon]
        with open(accuracy_csv_path, "w", encoding="utf-8") as f:
            f.write("timestamp,accuracy\n")
            for t in range(self.fut_window):
                tt = round((t + 1) * (1 / self.dataset_frequency), 3)
                f.write(f"{tt},{mean_acc[t]}\n")
        # cumulative means as in reference results.py:141-148
        cum = [sum(mean_acc[: i + 1]) / (i + 1) for i in range(self.fut_window)]
        print("Pretty Table...")
        print(ascii_table(
            [round((i + 1) * (1 / self.dataset_frequency), 3) for i in range(self.fut_window)],
            [[round(m, 5) for m in cum]]))

    def mean_accuracy(self) -> List[float]:
        return [float(np.mean(a)) for a in self.accuracy_per_horizon]

    def reset(self) -> None:
        self._rows.clear()
        self.accuracy_per_horizon = [[] for _ in range(self.fut_window)]
