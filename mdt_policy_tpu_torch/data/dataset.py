"""CALVIN episode dataset: host-side indexing + chunk assembly (a copy of
`mdt_policy_tpu/data/dataset.py` that makes the same random calls in the
same order, so both packages give the same samples from the same seed).

Re-implements the production data path of the reference —
`ExtendedDiskDataset` (`mdt/datasets/disk_dataset.py:162-336`) over CALVIN
per-frame `episode_{idx:07d}.npz` files — as a plain-numpy dataset that feeds
the on-device preprocessing stage (transforms.py). Design split vs. the
reference: the host does ONLY file IO + index math; all pixel work (resize,
shift-aug, normalize) runs on the device.

Per-sample layout (obs_seq_len=1, action_seq_len=10 production config):
  start  = episode_lookup[idx]
  obs    = frames [start, start+obs_seq_len)
  gen    = frame  start + obs_seq_len + img_gen_frame_diff - 1   (ref :228)
  acts   = rel_actions rows [start+obs_seq_len-1, +action_seq_len) (ref :250)
  goal   = frame  start + action_seq_len + obs_seq_len - 1 + window_size,
           clipped to the episode end (ref :274-281)
  rgb_*  = concat(obs frames, goal frame)  -> (obs_seq_len+1, H, W, 3)

Fast path: `extracted/ep_rel_actions.npy` + `ep_npz_names.list` (built by
data/extract.py, mirroring preprocess/extract_by_key.py) replaces the
10-npz-per-sample action reads (ref :184-197, README's ~2GB/iteration cost).

One difference from the JAX package: numpy has no bfloat16 and the port
does not depend on `ml_dtypes`, so cached Voltron tokens (`voltron_tokens`)
come out as their raw uint16 bits, the cache's own layout;
`loader.Preprocessor.train_batch` views them as torch.bfloat16.

`replay_draws` makes the random calls of a batch without reading it: the
loader's `start_batch` fast-forward replays the skipped batches with it, so
that a resumed run with one decode thread draws the windows an
uninterrupted one draws.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .windows import sample_window_size

logger = logging.getLogger(__name__)

__all__ = ["CalvinDataset", "build_vision_indices", "build_lang_indices",
           "lookup_naming_pattern"]


def lookup_naming_pattern(dataset_dir: Path, save_format: str = "npz"):
    """Infer the frame-file naming pattern (ref episode_utils.py:218-236)."""
    it = (p for p in Path(dataset_dir).glob(f"**/*.{save_format}")
          if "extracted" not in str(p))
    filename = next(it)
    aux_naming_pattern = str(filename.stem).rsplit("_", 1)
    naming_pattern = (filename.parent / f"{aux_naming_pattern[0]}_", f".{save_format}")
    n_digits = len(str(filename.stem).rsplit("_", 1)[-1])
    return naming_pattern, n_digits


def build_vision_indices(dataset_dir: Path, min_window_size: int) -> np.ndarray:
    """Every frame that can start a window (ref disk_dataset.py:315-336)."""
    ep_start_end_ids = np.load(Path(dataset_dir) / "ep_start_end_ids.npy")
    episode_lookup = []
    for start_idx, end_idx in ep_start_end_ids:
        for idx in range(start_idx, end_idx + 1 - min_window_size):
            episode_lookup.append(idx)
    return np.asarray(episode_lookup, dtype=np.int64)


def build_lang_indices(dataset_dir: Path, lang_folder: str, min_window_size: int,
                       skip_frames: int = 1):
    """Language-annotated windows from auto_lang_ann.npy
    (ref disk_dataset.py:98-136). Returns (episode_lookup, lang_lookup,
    lang_emb, lang_text)."""
    dataset_dir = Path(dataset_dir)
    for cand in (dataset_dir / lang_folder / "auto_lang_ann.npy",
                 dataset_dir / "auto_lang_ann.npy"):
        if cand.exists():
            lang_data = np.load(cand, allow_pickle=True).item()
            break
    else:
        raise FileNotFoundError(f"auto_lang_ann.npy not found under {dataset_dir}")
    ep_start_end_ids = lang_data["info"]["indx"]
    lang_emb = lang_data["language"]["emb"]
    lang_text = lang_data["language"]["ann"]
    episode_lookup, lang_lookup = [], []
    for i, (start_idx, end_idx) in enumerate(ep_start_end_ids):
        cnt = 0
        for idx in range(start_idx, end_idx + 1 - min_window_size):
            if cnt % skip_frames == 0:
                lang_lookup.append(i)
                episode_lookup.append(idx)
            cnt += 1
    return (np.asarray(episode_lookup, dtype=np.int64), np.asarray(lang_lookup),
            lang_emb, lang_text)


class CalvinDataset:
    """Index-based sample assembly over a CALVIN episode directory."""

    RGB_KEYS = ("rgb_static", "rgb_gripper")

    def __init__(
        self,
        dataset_dir: os.PathLike,
        key: str = "vis",  # 'vis' or 'lang'
        lang_folder: str = "lang_clip_resnet50",
        obs_seq_len: int = 1,
        action_seq_len: int = 10,
        min_window_size: int = 21,
        max_window_size: int = 50,
        img_gen_frame_diff: int = 3,
        window_sampling_strategy: str = "geometric",
        geometric_p: float = 0.1,
        use_extracted_rel_actions: bool = True,
        use_extracted_frames: bool = True,
        use_extracted_embeddings: bool = False,
        embedding_aug_variants: int = 0,
        skip_frames: int = 1,
        seed: int = 0,
        proprio: bool = False,
        proprio_cfg: Optional["ProprioConfig"] = None,
        include_scene_obs: bool = False,
        depth_keys: tuple = (),
    ):
        self.dataset_dir = Path(dataset_dir)
        self.with_lang = key == "lang"
        self.validation = "validation" in self.dataset_dir.as_posix()
        self.obs_seq_len = obs_seq_len
        self.action_seq_len = action_seq_len
        self.min_window_size = min_window_size
        self.max_window_size = max_window_size
        self.img_gen_frame_diff = img_gen_frame_diff
        self.random_frame_diff = img_gen_frame_diff <= -1  # (ref :180)
        self.window_sampling_strategy = window_sampling_strategy
        self.geometric_p = geometric_p
        self.seed = seed
        # per-thread rng: __getitem__ runs concurrently under the loader's
        # decode pool and np.random.Generator is not thread-safe (matches the
        # reference's per-worker DataLoader seeding; train windows are
        # stochastic by design, validation windows are hash-deterministic)
        self._local = threading.local()
        self._thread_counter = itertools.count()

        # proprio path (ref episode_utils.py:14-61): normalize with the
        # dataset's statistics.yaml, slice keep_indices -> n_state_obs dims
        from .proprio import ProprioConfig, load_statistics
        self.proprio = proprio
        self.proprio_cfg = proprio_cfg or ProprioConfig()
        self.statistics = load_statistics(self.dataset_dir) if proprio else {}
        self.include_scene_obs = include_scene_obs
        self.depth_keys = tuple(depth_keys)

        if self.with_lang:
            (self.episode_lookup, self.lang_lookup, self.lang_emb,
             self.lang_text) = build_lang_indices(
                self.dataset_dir, lang_folder, min_window_size, skip_frames)
        else:
            self.episode_lookup = build_vision_indices(self.dataset_dir, min_window_size)
        self.ep_start_end_ids = np.load(self.dataset_dir / "ep_start_end_ids.npy")
        self.naming_pattern, self.n_digits = lookup_naming_pattern(self.dataset_dir)

        self.use_extracted = use_extracted_rel_actions
        if use_extracted_rel_actions:
            ex_dir = self.dataset_dir / "extracted"
            if not ex_dir.exists():
                raise FileNotFoundError(
                    f"{ex_dir} missing — run mdt_policy_tpu_torch.data.extract first "
                    "or pass use_extracted_rel_actions=False")
            with open(ex_dir / "ep_npz_names.list") as f:
                names = [int(x.strip()) for x in f]
            self.ex_name_to_idx = {n: i for i, n in enumerate(names)}
            # mmap: zero-copy row reads (ref loads fully; mmap is strictly better)
            self.ex_rel_actions = np.load(ex_dir / "ep_rel_actions.npy", mmap_mode="r")

        # extracted-FRAMES fast path (beyond-reference: data/extract.py
        # extract_frames): contiguous uint8 mmap row gathers replace per-frame
        # npz zip parsing (~20x faster per core) when the arrays exist
        self.ex_frames = None
        ex_dir = self.dataset_dir / "extracted"
        if use_extracted_frames and (ex_dir / "ep_rgb_static.npy").exists():
            from .extract import FRAME_KEYS
            self.ex_frames = {
                k: np.load(ex_dir / f"ep_{k}.npy", mmap_mode="r")
                for k in FRAME_KEYS if (ex_dir / f"ep_{k}.npy").exists()}
            if not hasattr(self, "ex_name_to_idx"):
                with open(ex_dir / "ep_npz_names.list") as f:
                    names = [int(x.strip()) for x in f]
                self.ex_name_to_idx = {n: i for i, n in enumerate(names)}
            logger.info("using extracted frame arrays: %s", sorted(self.ex_frames))
        # precomputed frozen-tower embeddings (data/extract_embeddings.py):
        # samples carry voltron_tokens + image_latent_goal instead of raw
        # camera frames; the train step never runs the camera towers
        self.use_embeddings = use_extracted_embeddings
        if use_extracted_embeddings:
            if obs_seq_len != 1:
                raise ValueError("use_extracted_embeddings supports "
                                 "obs_seq_len=1 (the production config); "
                                 f"got {obs_seq_len}")
            from .extract_embeddings import EMBEDDING_FILES
            missing = [f for f in EMBEDDING_FILES if not (ex_dir / f).exists()]
            if missing:
                raise FileNotFoundError(
                    f"{missing} missing under {ex_dir} — run "
                    "mdt_policy_tpu_torch.data.extract_embeddings on this split "
                    "first, or unset use_extracted_embeddings")
            # bf16 stored as raw uint16 bits (np has no bf16); rows stay
            # uint16 bits until the Preprocessor views them as bf16
            self.ex_voltron_tokens = np.load(ex_dir / "ep_voltron_tokens.npy",
                                             mmap_mode="r")
            self.ex_clip_img_emb = np.load(ex_dir / "ep_clip_img_emb.npy",
                                           mmap_mode="r")
            # DrQ-augmented variant arrays (extract_embeddings --aug-variants):
            # train draws sample one of K cached shift variants per frame —
            # the cache-mode equivalent of the in-program RandomShiftsAug.
            # Validation splits keep the clean arrays (the reference's val
            # pipelines apply no aug).
            self.aug_variants = 0 if self.validation \
                else int(embedding_aug_variants)
            if self.aug_variants:
                from .extract_embeddings import AUG_EMBEDDING_FILES
                missing = [f for f in AUG_EMBEDDING_FILES
                           if not (ex_dir / f).exists()]
                if missing:
                    raise FileNotFoundError(
                        f"{missing} missing under {ex_dir} — re-run "
                        "mdt_policy_tpu_torch.data.extract_embeddings with "
                        f"--aug-variants {embedding_aug_variants}, or unset "
                        "embedding_aug_variants")
                self.ex_voltron_tokens_aug = np.load(
                    ex_dir / "ep_voltron_tokens_aug.npy", mmap_mode="r")
                self.ex_clip_img_emb_aug = np.load(
                    ex_dir / "ep_clip_img_emb_aug.npy", mmap_mode="r")
                k_cached = self.ex_voltron_tokens_aug.shape[1]
                if self.aug_variants > k_cached:
                    raise ValueError(
                        f"embedding_aug_variants={self.aug_variants} but the "
                        f"cache holds only {k_cached} variants")
            # optional text-goal cache (per annotation sentence): with it the
            # train step runs NO tower at all; absent -> the in-program CLIP
            # text tower encodes lang_tokens as usual
            self.ex_lang_goal = None
            if self.with_lang and (ex_dir / "ep_lang_goal_emb.npy").exists():
                self.ex_lang_goal = np.load(ex_dir / "ep_lang_goal_emb.npy")
                if len(self.ex_lang_goal) != len(self.lang_text):
                    raise ValueError(
                        f"ep_lang_goal_emb.npy has {len(self.ex_lang_goal)} "
                        f"rows but the split has {len(self.lang_text)} "
                        "annotations — re-run extract_embeddings")
            if not hasattr(self, "ex_name_to_idx"):
                with open(ex_dir / "ep_npz_names.list") as f:
                    names = [int(x.strip()) for x in f]
                self.ex_name_to_idx = {n: i for i, n in enumerate(names)}
        if hasattr(self, "ex_name_to_idx"):
            # sorted file-id array for vectorized id->row mapping (get_batch)
            self._ex_names = np.asarray(sorted(self.ex_name_to_idx), np.int64)

    def __len__(self) -> int:
        return len(self.episode_lookup)

    @property
    def rng(self) -> np.random.Generator:
        rng = getattr(self._local, "rng", None)
        if rng is None:
            rng = np.random.default_rng(self.seed + next(self._thread_counter))
            self._local.rng = rng
        return rng

    # ---- file access ---------------------------------------------------------

    def _frame_path(self, file_idx: int) -> Path:
        return Path(f"{self.naming_pattern[0]}{file_idx:0{self.n_digits}d}"
                    f"{self.naming_pattern[1]}")

    def _load_frame(self, file_idx: int) -> Dict[str, np.ndarray]:
        return np.load(self._frame_path(file_idx))

    def _frame_arrays(self, file_idx: int, keys) -> Dict[str, np.ndarray]:
        """Per-frame key reads: extracted mmap rows when available, npz
        parse otherwise."""
        if self.ex_frames is not None and all(k in self.ex_frames for k in keys):
            row = self.ex_name_to_idx[file_idx]
            return {k: np.asarray(self.ex_frames[k][row]) for k in keys}
        d = self._load_frame(file_idx)
        return {k: np.asarray(d[k]) for k in keys}

    def _episode_bounds(self, idx: int):
        """(ref find_sequence_boundaries, disk_dataset.py:199-203)"""
        for start_idx, end_idx in self.ep_start_end_ids:
            if start_idx <= idx < end_idx:
                return int(start_idx), int(end_idx)
        raise ValueError(f"Index {idx} does not belong to any sequence.")

    # ---- sample assembly -------------------------------------------------------

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        window_size = sample_window_size(
            self.episode_lookup, idx, self.min_window_size, self.max_window_size,
            validation=self.validation, strategy=self.window_sampling_strategy,
            geometric_p=self.geometric_p, rng=self.rng)
        start_idx = int(self.episode_lookup[idx])
        end_idx = start_idx + self.action_seq_len + self.obs_seq_len - 1

        if self.random_frame_diff:
            frame_diff = int(self.rng.integers(0, self.action_seq_len))
        else:
            frame_diff = self.img_gen_frame_diff
        gen_img_idx = start_idx + self.obs_seq_len + frame_diff - 1

        obs_keys = (("robot_obs",) if self.use_embeddings
                    else self.RGB_KEYS + ("robot_obs",))
        obs_frames = [self._frame_arrays(i, obs_keys)
                      for i in range(start_idx, start_idx + self.obs_seq_len)]
        gen_frame = self._frame_arrays(gen_img_idx, self.RGB_KEYS)

        if self.use_extracted:
            rows = [self.ex_name_to_idx[i] for i in range(start_idx, end_idx)]
            actions_full = np.asarray(self.ex_rel_actions[rows, :], np.float32)
        else:
            acts = [np.asarray(self._load_frame(i)["rel_actions"], np.float32)
                    for i in range(start_idx, end_idx)]
            actions_full = np.stack(acts)
        actions = actions_full[self.obs_seq_len - 1:
                               self.obs_seq_len - 1 + self.action_seq_len]

        # future-goal frame, clipped to the episode end (ref :274-281)
        goal_idx = end_idx + window_size
        _, eps_end = self._episode_bounds(end_idx)
        goal_idx = min(goal_idx, eps_end)
        goal_frame = self._frame_arrays(goal_idx, obs_keys)

        sample: Dict[str, np.ndarray] = {
            "actions": actions,
            "robot_obs": np.stack(
                [np.asarray(f["robot_obs"], np.float32) for f in obs_frames]
                + [np.asarray(goal_frame["robot_obs"], np.float32)]),
            "idx": np.asarray(idx, np.int64),
            "future_frame_diff": np.asarray(frame_diff, np.int32),
            "gen_static": gen_frame["rgb_static"],
            "gen_gripper": gen_frame["rgb_gripper"],
        }
        if self.use_embeddings:
            row = self.ex_name_to_idx[start_idx]  # obs_seq_len == 1
            goal_row = self.ex_name_to_idx[goal_idx]
            if self.aug_variants:
                # one cached shift variant per draw — obs and goal frames
                # draw independently, like the in-program per-frame shifts
                k_obs, k_goal = self.rng.integers(0, self.aug_variants, 2)
                sample["voltron_tokens"] = np.asarray(
                    self.ex_voltron_tokens_aug[row, k_obs])
                sample["image_latent_goal"] = np.asarray(
                    self.ex_clip_img_emb_aug[goal_row, k_goal], np.float32)
            else:
                sample["voltron_tokens"] = np.asarray(
                    self.ex_voltron_tokens[row])
                sample["image_latent_goal"] = np.asarray(
                    self.ex_clip_img_emb[goal_row], np.float32)
            if self.with_lang and self.ex_lang_goal is not None:
                sample["lang_latent_goal"] = np.asarray(
                    self.ex_lang_goal[int(self.lang_lookup[idx])], np.float32)
        else:
            for k in self.RGB_KEYS:
                sample[k] = np.stack([f[k] for f in obs_frames] + [goal_frame[k]])
        if self.proprio:
            from .proprio import process_state
            obs_robot = sample["robot_obs"][:self.obs_seq_len]
            sample["state_obs"] = process_state(obs_robot, self.statistics,
                                                self.proprio_cfg)
        if self.include_scene_obs:
            # raw scene state for env resets (ref get_state_info_dict)
            frames = [self._frame_arrays(i, ("scene_obs",))
                      for i in range(start_idx, start_idx + self.obs_seq_len)]
            frames.append(self._frame_arrays(goal_idx, ("scene_obs",)))
            sample["scene_obs"] = np.stack(
                [np.asarray(f["scene_obs"], np.float32) for f in frames])
        for dk in self.depth_keys:
            d = [np.asarray(self._load_frame(i)[dk], np.float32)
                 for i in range(start_idx, start_idx + self.obs_seq_len)]
            d.append(np.asarray(self._load_frame(goal_idx)[dk], np.float32))
            sample[dk] = np.stack(d)
        if self.with_lang:
            li = int(self.lang_lookup[idx])
            sample["lang_emb"] = np.asarray(self.lang_emb[li][0], np.float32)
            sample["lang_text"] = self.lang_text[li]
        return sample

    # ---- vectorized batch assembly ------------------------------------------

    def _ex_rows(self, file_ids: np.ndarray) -> np.ndarray:
        """file id -> extracted row index, vectorized (extraction order is
        sorted file-id order)."""
        rows = np.searchsorted(self._ex_names, file_ids)
        if not np.array_equal(self._ex_names[rows], file_ids):
            raise KeyError("frame ids missing from extracted arrays")
        return rows

    def _episode_ends(self, idxs: np.ndarray) -> np.ndarray:
        """Vectorized episode-end lookup (ref find_sequence_boundaries)."""
        starts = self.ep_start_end_ids[:, 0]
        pos = np.searchsorted(starts, idxs, side="right") - 1
        return self.ep_start_end_ids[pos, 1]

    def can_gather(self) -> bool:
        """Whether `get_batch` can assemble batches (the extracted arrays
        it gathers from exist)."""
        needed = set(self.RGB_KEYS) | {"robot_obs"}
        if self.include_scene_obs:
            needed.add("scene_obs")
        return not (self.ex_frames is None or not needed <= set(self.ex_frames)
                    or not self.use_extracted or self.depth_keys)

    def replay_draws(self, idxs: np.ndarray, *, batched: bool) -> None:
        """Make the random calls that assembling `idxs` makes, in the same
        order, without reading a frame: `get_batch`'s (`batched`) or those
        of one `__getitem__` per index."""
        rng = self.rng
        aug = self.use_embeddings and self.aug_variants
        for i in np.asarray(idxs, np.int64):
            sample_window_size(self.episode_lookup, int(i), self.min_window_size,
                               self.max_window_size, validation=self.validation,
                               strategy=self.window_sampling_strategy,
                               geometric_p=self.geometric_p, rng=rng)
            if not batched:
                if self.random_frame_diff:
                    rng.integers(0, self.action_seq_len)
                if aug:
                    rng.integers(0, self.aug_variants, 2)
        if batched:
            B = len(idxs)
            if self.random_frame_diff:
                rng.integers(0, self.action_seq_len, B)
            if aug:
                rng.integers(0, self.aug_variants, B)
                rng.integers(0, self.aug_variants, B)

    def get_batch(self, idxs: np.ndarray) -> Optional[Dict[str, np.ndarray]]:
        """Assemble a whole batch with ONE fancy-index gather per key — the
        fast path over extracted frame arrays. Per-sample npz assembly pays
        ~3 zip parses + ~10 python-level array ops per sample; a batched
        contiguous-row gather is a single C loop per key. Returns None when
        the extracted arrays are unavailable (caller falls back to
        per-sample __getitem__). Semantics identical to __getitem__.
        """
        if not self.can_gather():
            return None
        idxs = np.asarray(idxs, np.int64)
        B = len(idxs)
        rng = self.rng
        windows = np.asarray(
            [sample_window_size(self.episode_lookup, int(i), self.min_window_size,
                                self.max_window_size, validation=self.validation,
                                strategy=self.window_sampling_strategy,
                                geometric_p=self.geometric_p, rng=rng)
             for i in idxs], np.int64)
        starts = self.episode_lookup[idxs]
        ends = starts + self.action_seq_len + self.obs_seq_len - 1
        if self.random_frame_diff:
            frame_diff = rng.integers(0, self.action_seq_len, B)
        else:
            frame_diff = np.full(B, self.img_gen_frame_diff, np.int64)
        gen_ids = starts + self.obs_seq_len + frame_diff - 1
        goal_ids = np.minimum(ends + windows, self._episode_ends(ends))

        # (B, obs_seq_len + 1) frame ids: obs frames then the future goal
        obs_ids = starts[:, None] + np.arange(self.obs_seq_len)[None, :]
        frame_ids = np.concatenate([obs_ids, goal_ids[:, None]], axis=1)
        rows = self._ex_rows(frame_ids.ravel())
        T = self.obs_seq_len + 1
        batch: Dict[str, np.ndarray] = {}
        if self.use_embeddings:
            obs_rows = self._ex_rows(starts)  # obs_seq_len == 1
            if self.aug_variants:
                k_obs = rng.integers(0, self.aug_variants, B)
                k_goal = rng.integers(0, self.aug_variants, B)
                batch["voltron_tokens"] = np.asarray(
                    self.ex_voltron_tokens_aug[obs_rows, k_obs])
                batch["image_latent_goal"] = np.asarray(
                    self.ex_clip_img_emb_aug[self._ex_rows(goal_ids), k_goal],
                    np.float32)
            else:
                batch["voltron_tokens"] = np.asarray(
                    self.ex_voltron_tokens[obs_rows])
                batch["image_latent_goal"] = np.asarray(
                    self.ex_clip_img_emb[self._ex_rows(goal_ids)], np.float32)
            if self.with_lang and self.ex_lang_goal is not None:
                batch["lang_latent_goal"] = np.asarray(
                    self.ex_lang_goal[self.lang_lookup[idxs]], np.float32)
        else:
            for k in self.RGB_KEYS:
                arr = self.ex_frames[k][rows]
                batch[k] = arr.reshape((B, T) + arr.shape[1:])
        robs = self.ex_frames["robot_obs"][rows].astype(np.float32)
        batch["robot_obs"] = robs.reshape(B, T, -1)

        gen_rows = self._ex_rows(gen_ids)
        batch["gen_static"] = self.ex_frames["rgb_static"][gen_rows]
        batch["gen_gripper"] = self.ex_frames["rgb_gripper"][gen_rows]

        act_ids = (starts[:, None] + self.obs_seq_len - 1
                   + np.arange(self.action_seq_len)[None, :])
        act_rows = self._ex_rows(act_ids.ravel())
        batch["actions"] = np.asarray(
            self.ex_rel_actions[act_rows], np.float32).reshape(
                B, self.action_seq_len, -1)

        if self.proprio:
            from .proprio import process_state
            batch["state_obs"] = process_state(
                batch["robot_obs"][:, :self.obs_seq_len], self.statistics,
                self.proprio_cfg)
        if self.include_scene_obs:
            scn = self.ex_frames["scene_obs"][rows].astype(np.float32)
            batch["scene_obs"] = scn.reshape(B, T, -1)

        batch["idx"] = idxs
        batch["future_frame_diff"] = frame_diff.astype(np.int32)
        if self.with_lang:
            li = self.lang_lookup[idxs]
            batch["lang_emb"] = np.stack(
                [np.asarray(self.lang_emb[int(i)][0], np.float32) for i in li])
            batch["lang_text"] = [self.lang_text[int(i)] for i in li]
        return batch
