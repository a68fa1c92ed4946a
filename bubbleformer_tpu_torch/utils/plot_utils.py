"""Host-side visualization of rollouts and validation samples.

A copy of ``bubbleformer_tpu/utils/plot_utils.py`` (numpy/matplotlib only):
the port cannot import it from there, since importing any module of the JAX
package imports jax.

Counterpart of reference ``bubbleformer/utils/plot_utils.py``: per-timestep
2x3 panels (SDF with bubble-interface overlay, temperature, velocity
magnitude + streamlines) plus a relative-L2-vs-time curve.  Pure host-side
numpy/matplotlib/OpenCV — never on the device path.
"""
from __future__ import annotations

import os
from typing import Optional

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


def bubble_interface_overlay(sdf: np.ndarray) -> np.ndarray:
    """RGBA overlay marking the liquid/vapor interface of an SDF frame.

    Thresholds the SDF into a binary phase mask, extracts the phase boundary
    (Canny + dilate when OpenCV is available, morphological gradient via
    numpy otherwise) and returns an (H, W, 4) overlay.
    """
    phase = np.where(sdf < 0, 255, 0).astype(np.uint8)
    if _HAS_CV2:
        edges = cv2.Canny(phase, 0, 255)
        edges = cv2.dilate(edges, np.ones((3, 3), np.uint8), iterations=1)
    else:
        pad = np.pad(phase > 0, 1, mode="edge")
        neighborhood_any = np.zeros_like(phase, dtype=bool)
        neighborhood_all = np.ones_like(phase, dtype=bool)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                shifted = pad[1 + dy : 1 + dy + phase.shape[0], 1 + dx : 1 + dx + phase.shape[1]]
                neighborhood_any |= shifted
                neighborhood_all &= shifted
        edges = (neighborhood_any & ~neighborhood_all).astype(np.uint8) * 255
    mask = np.where(edges > 0, 0, 255)
    alpha = np.where(mask > 0, 0, 255)
    return np.dstack((mask, mask, mask, alpha)).astype(np.uint8)


def relative_l2_curve(preds: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """(T, C, H, W) -> (T, C) relative L2 error per field per step."""
    diff = np.linalg.norm(preds - targets, axis=(2, 3))
    norm = np.linalg.norm(targets, axis=(2, 3))
    return diff / norm


def plot_relative_l2(
    preds: np.ndarray,
    targets: np.ndarray,
    timesteps: np.ndarray,
    save_path: str,
    field_names=("SDF", "Temp", "VelX", "VelY"),
) -> None:
    err = relative_l2_curve(preds, targets)
    plt.figure(figsize=(10, 6))
    for c, name in enumerate(field_names[: err.shape[1]]):
        plt.plot(timesteps, err[:, c], label=name)
    plt.xlabel("Time (timesteps)")
    plt.ylabel("Relative L2 Error")
    plt.title("Relative L2 Error over Time for Each Variable")
    plt.legend()
    plt.grid(True)
    plt.savefig(save_path)
    plt.close()


def _robust_limits(x: np.ndarray):
    mean, std = float(np.mean(x)), float(np.std(x))
    return round(mean - 3 * std, 2), round(mean + 3 * std, 2)


def plot_bubbleml(
    preds: np.ndarray,
    targets: np.ndarray,
    timesteps: np.ndarray,
    save_dir: str,
    max_frames: Optional[int] = None,
) -> None:
    """Per-timestep 2x3 target/prediction panels for a (T, 4, H, W) rollout."""
    plot_dir = os.path.join(save_dir, "plots")
    os.makedirs(plot_dir, exist_ok=True)

    plot_relative_l2(
        preds, targets, timesteps, os.path.join(save_dir, "relative_l2_error.png")
    )

    sdf_min, sdf_max = _robust_limits(targets[:, 0])
    temp_min, temp_max = _robust_limits(targets[:, 1])
    vel_mag = np.sqrt(targets[:, 2] ** 2 + targets[:, 3] ** 2)
    vel_min, vel_max = _robust_limits(vel_mag)

    n_frames = preds.shape[0] if max_frames is None else min(max_frames, preds.shape[0])
    for i in range(n_frames):
        fig, axes = plt.subplots(2, 3, figsize=(15, 10), layout="constrained")
        for row, data in enumerate((targets, preds)):
            kind = "Label" if row == 0 else "Pred"
            sdf = data[i, 0]
            im = axes[row][0].imshow(sdf, vmin=sdf_min, vmax=sdf_max, cmap="Blues", origin="lower")
            axes[row][0].imshow(bubble_interface_overlay(sdf), origin="lower")
            axes[row][0].axis("off")
            fig.colorbar(im, ax=axes[row][0], fraction=0.04, pad=0.05)
            axes[row][0].set_title(f"SDF {kind} {i}")

            im = axes[row][1].imshow(
                data[i, 1], cmap="turbo", vmin=temp_min, vmax=temp_max, origin="lower"
            )
            axes[row][1].axis("off")
            fig.colorbar(im, ax=axes[row][1], fraction=0.04, pad=0.05)
            axes[row][1].set_title(f"Temp {kind} {i}")

            vx, vy = data[i, 2].copy(), data[i, 3].copy()
            vx[targets[i, 0] == 0] = 0
            vy[targets[i, 0] == 0] = 0
            vmag = np.sqrt(vx**2 + vy**2)
            im = axes[row][2].imshow(np.flipud(vmag), vmin=vel_min, vmax=vel_max, cmap="turbo")
            xs = np.arange(2, vmag.shape[1] - 2)
            ys = np.arange(2, vmag.shape[0] - 2)
            gx, gy = np.meshgrid(xs, ys)
            axes[row][2].streamplot(
                gx,
                gy,
                np.flipud(vx)[2:-2, 2:-2],
                -np.flipud(vy)[2:-2, 2:-2],
                density=0.75,
                color="white",
            )
            axes[row][2].axis("off")
            fig.colorbar(im, ax=axes[row][2], fraction=0.04, pad=0.05)
            axes[row][2].set_title(f"Vel {kind} {i}")

        fig.savefig(os.path.join(plot_dir, f"{i:04d}.png"), bbox_inches="tight")
        plt.close(fig)


def sdf_panel(sdf: np.ndarray):
    """1xT SDF panel with interface overlays (W&B-style val image)."""
    fig, axes = plt.subplots(1, sdf.shape[0], figsize=(3 * sdf.shape[0], 6))
    axes = np.atleast_1d(axes)
    for i, ax in enumerate(axes):
        img = ax.imshow(sdf[i], cmap="Blues", origin="lower")
        ax.imshow(bubble_interface_overlay(sdf[i]), origin="lower")
        ax.axis("off")
        ax.set_title(f"SDF {i}")
    fig.colorbar(img, fraction=0.04, pad=0.05)
    return fig


def temp_panel(temp: np.ndarray):
    """1xT temperature panel."""
    fig, axes = plt.subplots(1, temp.shape[0], figsize=(3 * temp.shape[0], 6))
    axes = np.atleast_1d(axes)
    for i, ax in enumerate(axes):
        img = ax.imshow(temp[i], cmap="turbo", origin="lower")
        ax.axis("off")
        ax.set_title(f"Temp {i}")
    fig.colorbar(img, fraction=0.04, pad=0.05)
    return fig


def vel_panel(vel: np.ndarray):
    """1xT velocity panel with streamlines for a (T, 2, H, W) stack."""
    fig, axes = plt.subplots(1, vel.shape[0], figsize=(3 * vel.shape[0], 6))
    axes = np.atleast_1d(axes)
    for i, ax in enumerate(axes):
        vx, vy = vel[i, 0], vel[i, 1]
        vmag = np.sqrt(vx**2 + vy**2)
        gx, gy = np.meshgrid(np.arange(vmag.shape[1]), np.arange(vmag.shape[0]))
        img = ax.imshow(np.flipud(vmag), cmap="turbo")
        ax.streamplot(gx, gy, np.flipud(vx), -np.flipud(vy), density=0.75, color="white")
        ax.axis("off")
        ax.set_title(f"Vel {i}")
    fig.colorbar(img, fraction=0.04, pad=0.05)
    return fig
