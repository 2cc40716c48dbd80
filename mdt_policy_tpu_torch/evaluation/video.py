"""Rollout video recording (a copy of `mdt_policy_tpu/evaluation/video.py`,
the reference's RolloutVideo, `mdt/rollout/rollout_video.py:39-320`):
collects frames per subtask, draws a success/fail border and the language
caption, and publishes to every available sink (ref `log_to_wandb` /
`_log_video_to_file`, :149-263):

* animated GIF to disk (PIL);
* mp4 to disk when an encoder is importable (imageio/cv2 probed at run
  time; without one the video is the GIF alone);
* `wandb.Video` when a wandb run is active (probed at run time).

PIL is imported only where it is used, when a caption is drawn or a file is
written; without it those calls raise an ImportError that names PIL, so a
video that was asked for is never skipped silently. Frames, borders and
captions are the JAX package's element for element.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["RolloutVideo"]

GREEN = (40, 180, 70)
RED = (200, 50, 40)


def _pil():
    """PIL's `Image` and `ImageDraw`, or an ImportError that names PIL."""
    try:
        from PIL import Image, ImageDraw
    except ImportError as e:
        raise ImportError("RolloutVideo needs PIL (the Pillow package) to draw captions "
                          "and write videos; install Pillow or record no video") from e
    return Image, ImageDraw


class RolloutVideo:
    def __init__(self, save_dir, fps: int = 15, border: int = 4):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.fps = fps
        self.border = border
        self._frames: List[np.ndarray] = []
        self._subtask_start = 0
        self._tag = "rollout"
        self._caption: Optional[str] = None

    def new_video(self, tag: str, caption: Optional[str] = None):
        self._frames = []
        self._subtask_start = 0
        self._tag = tag
        self._caption = caption

    def new_subtask(self):
        self._subtask_start = len(self._frames)

    def update(self, rgb_frame: np.ndarray):
        """Add one env frame (H, W, 3) uint8 (or any squeezable shape)."""
        f = np.asarray(rgb_frame)
        f = f.reshape(f.shape[-3], f.shape[-2], f.shape[-1]).astype(np.uint8)
        self._frames.append(f)

    def draw_outcome(self, success: bool):
        """Tint the border of the finished subtask's frames (ref :draw border)."""
        color = GREEN if success else RED
        b = self.border
        for i in range(self._subtask_start, len(self._frames)):
            f = self._frames[i].copy()
            f[:b, :] = color
            f[-b:, :] = color
            f[:, :b] = color
            f[:, -b:] = color
            self._frames[i] = f

    def add_language_instruction(self, text: str):
        Image, ImageDraw = _pil()
        for i in range(self._subtask_start, len(self._frames)):
            img = Image.fromarray(self._frames[i])
            d = ImageDraw.Draw(img)
            d.text((self.border + 2, self.border + 2), text, fill=(255, 255, 255))
            self._frames[i] = np.asarray(img)

    def write(self) -> Optional[Path]:
        """Write the GIF (+ mp4 when an encoder exists) and log to wandb when
        a run is active. Returns the GIF path."""
        if not self._frames:
            return None
        Image, _ = _pil()
        path = self.save_dir / f"{self._tag}.gif"
        imgs = [Image.fromarray(f) for f in self._frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / self.fps), loop=0)
        self._write_mp4()
        self._log_wandb()
        return path

    def _write_mp4(self) -> Optional[Path]:
        """(ref _log_video_to_file, rollout_video.py:230-263) — mp4 via any
        available encoder; without one the video is the GIF alone."""
        path = self.save_dir / f"{self._tag}.mp4"
        try:
            import imageio

            imageio.mimwrite(path, self._frames, fps=self.fps)
            return path
        except Exception:  # missing package OR missing ffmpeg backend
            path.unlink(missing_ok=True)
        try:
            import cv2

            h, w = self._frames[0].shape[:2]
            vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                                 self.fps, (w, h))
            for f in self._frames:
                vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            vw.release()
            return path
        except Exception:
            logger.debug("no mp4 encoder (imageio/cv2); GIF only")
            return None

    def _log_wandb(self):
        """(ref log_to_wandb, rollout_video.py:149-196) — wandb.Video of the
        frame stack (T, C, H, W uint8) when a run is active."""
        try:
            import wandb

            if wandb.run is None:
                return
            frames = np.stack(self._frames).transpose(0, 3, 1, 2)
            wandb.log({f"video/{self._tag}":
                       wandb.Video(frames, fps=self.fps,
                                   caption=self._caption or self._tag)})
        except ImportError:
            pass
