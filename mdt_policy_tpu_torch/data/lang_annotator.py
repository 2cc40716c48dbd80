"""CALVIN's automatic language annotator (port of
`mdt_policy_tpu/data/lang_annotator.py`; reference
`mdt/utils/automatic_lang_annotator_mp.py:47-371`): scan each episode's
windows with the task oracle, give every window that completes exactly one
known task a sentence of the 389-sentence training table, embed the
sentences, and write `auto_lang_ann.npy` (training) and, with
`--validation`, `embeddings.npy` (the evaluator's goal lookup).

    python -m mdt_policy_tpu_torch.data.lang_annotator --root <split> \\
        [--embedder clip | minilm:<dir> | st:<name-or-path>] \\
        [--train-folder RUN] [--validation] [--device cpu] \\
        [--scripted-oracle TASK]

The embedders run on the card unless `--device cpu` is given (no card
raises): `clip`, the CLIP text tower (kernels B1 and B3) of a run
directory, or of a random-init `MDTVConfig()` net (logged as random);
`minilm:<dir>`, the port's MiniLM over a local HF or sentence-transformers
folder; `st:`, the external sentence-transformers package, imported when
named. Float32 matmuls run in full float32, not TF32. The task oracle is any
`(start_info, end_info) -> tasks` callable: calvin_env's, or with
`--scripted-oracle TASK` one that names TASK for every window.
"""

from __future__ import annotations

import argparse
import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["annotate_episodes", "scan_dataset", "write_auto_lang_ann", "write_embeddings",
           "clip_embed_fn", "st_embed_fn", "make_embed_fn", "main"]


def annotate_episodes(detect_tasks: Callable[[Dict, Dict], Sequence[str]],
                      frame_infos: Sequence[Dict], annotations: Dict[str, Sequence[str]], *,
                      window: int = 64, stride: int = 16,
                      rng: Optional[np.random.Generator] = None
                      ) -> Tuple[List[Tuple[int, int]], List[str], List[str]]:
    """Slide a window over the frame infos; where the oracle detects exactly
    one task that has annotations, record (start, end), the task and a
    sentence drawn from `rng`."""
    rng = rng or np.random.default_rng(0)
    indices, tasks, sentences = [], [], []
    for start in range(0, len(frame_infos) - window, stride):
        end = start + window
        detected = list(detect_tasks(frame_infos[start], frame_infos[end]))
        if len(detected) != 1 or detected[0] not in annotations:
            continue
        task = detected[0]
        indices.append((start, end))
        tasks.append(task)
        sentences.append(annotations[task][int(rng.integers(len(annotations[task])))])
    return indices, tasks, sentences


def write_auto_lang_ann(out_dir, indices, tasks, sentences, embeddings) -> Path:
    """auto_lang_ann.npy in the reference's layout: language.emb/ann/task and
    info.indx."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    data = {"language": {"emb": np.asarray(embeddings, np.float32), "ann": list(sentences),
                         "task": list(tasks)},
            "info": {"indx": list(indices)}}
    path = out_dir / "auto_lang_ann.npy"
    np.save(path, data, allow_pickle=True)
    logger.info("wrote %d annotations -> %s", len(sentences), path)
    return path


def write_embeddings(out_dir, val_annotations: Dict[str, Sequence[str]],
                     embed_fn: Callable[[str], np.ndarray]) -> Path:
    """embeddings.npy: {task: {"ann": [sentence], "emb": embedding}} of each
    task's first validation sentence."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    table = {task: {"ann": [sents[0]], "emb": np.asarray(embed_fn(sents[0]), np.float32)}
             for task, sents in val_annotations.items()}
    path = out_dir / "embeddings.npy"
    np.save(path, table, allow_pickle=True)
    logger.info("wrote %d goal embeddings -> %s", len(table), path)
    return path


def scan_dataset(dataset_dir, detect_tasks: Callable[[Dict, Dict], Sequence[str]],
                 annotations: Dict[str, Sequence[str]], *, window: int = 64,
                 stride: int = 16, num_workers: int = 4, seed: int = 0
                 ) -> Tuple[List[Tuple[int, int]], List[str], List[str]]:
    """Annotate every episode of a CALVIN split: the frame infos
    ({robot_obs, scene_obs}, the oracle's contract) from the extracted state
    arrays or the npz files, one `np.random.default_rng(seed + episode)` an
    episode, episodes in a thread pool mapped in order. Returns global
    frame indices, tasks and sentences."""
    from .dataset import CalvinDataset

    ds = CalvinDataset(dataset_dir, key="vis", min_window_size=1, max_window_size=1,
                       use_extracted_rel_actions=False, include_scene_obs=False)
    bounds = ds.ep_start_end_ids

    def scan_episode(ep_idx):
        start, end = int(bounds[ep_idx][0]), int(bounds[ep_idx][1])
        infos = [ds._frame_arrays(i, ("robot_obs", "scene_obs")) for i in range(start, end + 1)]
        idx, tasks, sents = annotate_episodes(
            detect_tasks, infos, annotations, window=window, stride=stride,
            rng=np.random.default_rng(seed + ep_idx))
        return [(a + start, b + start) for a, b in idx], tasks, sents

    indices, tasks, sentences = [], [], []
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for idx, tk, st in pool.map(scan_episode, range(len(bounds))):
            indices.extend(idx)
            tasks.extend(tk)
            sentences.extend(st)
    logger.info("scanned %d episodes -> %d annotated windows", len(bounds), len(indices))
    return indices, tasks, sentences


def clip_embed_fn(train_folder: Optional[str] = None, device=None):
    """sentence -> the CLIP text tower's embedding (float32), on `device`
    (default: CUDA): the tower of the run directory `train_folder` (its
    policy's EMA weights, `evaluate.build_policy`), else of a
    `MDTVConfig()` net with seeded random weights (format-correct,
    semantically untrained; logged)."""
    import torch

    from ..agents import MDTVConfig, init_random_, make_agent_net
    from ..utils.clip_tokenizer import tokenize

    if train_folder is not None:
        from ..evaluate import build_policy
        policy, agent_cfg, _ = build_policy(str(train_folder), device=device)
        net = policy.inner.net
    else:
        logger.warning("no --train-folder: embedding with a RANDOM-INIT CLIP text tower "
                       "(format-correct, semantically untrained)")
        agent_cfg = MDTVConfig()
        net = init_random_(make_agent_net(agent_cfg, device=device),
                           torch.Generator().manual_seed(0))
    device = next(net.parameters()).device

    def embed(sentence: str) -> np.ndarray:
        toks = torch.from_numpy(tokenize([sentence], agent_cfg.clip_context_length))
        with torch.no_grad():
            return net.encode_language_goal(toks.to(device))[0].cpu().numpy()

    return embed


def st_embed_fn(model_name_or_path: str):
    """The external sentence-transformers embedder (the family behind the
    published `lang_paraphrase-MiniLM-L3-v2` folders); the package is
    imported here, when named. Give a local folder where there is no
    network."""
    from sentence_transformers import SentenceTransformer

    model = SentenceTransformer(str(model_name_or_path))

    def embed(sentence: str) -> np.ndarray:
        return np.asarray(model.encode([sentence], convert_to_numpy=True,
                                       show_progress_bar=False)[0], np.float32)

    return embed


def make_embed_fn(spec: str, train_folder: Optional[str] = None, device=None):
    """The `--embedder` spec: "clip" (optionally restored from
    `train_folder`), "minilm:<dir>" (`models/minilm.py` over a local folder)
    or "st:<name-or-path>"."""
    if spec == "clip":
        return clip_embed_fn(train_folder, device)
    if spec.startswith("minilm:"):
        from ..models.minilm import minilm_embed_fn
        return minilm_embed_fn(spec[len("minilm:"):], device)
    if spec.startswith("st:"):
        return st_embed_fn(spec[3:])
    raise ValueError(f"unknown embedder spec {spec!r}; expected 'clip', "
                     "'minilm:<dir>' or 'st:<model-name-or-path>'")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", required=True, help="CALVIN split dir to scan")
    ap.add_argument("--out", default=None,
                    help="output lang folder (default <root>/lang_annotations)")
    ap.add_argument("--train-folder", default=None,
                    help="run dir whose CLIP text tower embeds the sentences")
    ap.add_argument("--embedder", default="clip",
                    help="'clip', 'minilm:<dir>' or 'st:<model-name-or-path>'")
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--stride", type=int, default=16)
    ap.add_argument("--validation", action="store_true",
                    help="also write embeddings.npy from the validation table")
    ap.add_argument("--scripted-oracle", default=None, metavar="TASK",
                    help="every window completes TASK (no calvin_env; a format "
                         "and pipeline check)")
    ap.add_argument("--device", default="cuda",
                    help="where the embedder runs (default cuda; cpu only when named)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..evaluation.annotations import (make_task_oracle, train_annotations,
                                          validation_annotations)
    from ..utils.misc import full_f32

    full_f32()
    if args.scripted_oracle:
        task = args.scripted_oracle
        detect = lambda a, b: [task]
    else:
        oracle = make_task_oracle()  # needs calvin_env
        detect = lambda a, b: oracle.get_task_info(a, b)
    indices, tasks, sentences = scan_dataset(args.root, detect, train_annotations(),
                                             window=args.window, stride=args.stride)
    embed = make_embed_fn(args.embedder, args.train_folder, args.device)
    embs = np.stack([embed(s) for s in sentences]) if sentences else \
        np.zeros((0, 512), np.float32)
    out = Path(args.out) if args.out else Path(args.root) / "lang_annotations"
    write_auto_lang_ann(out, indices, tasks, sentences, embs[:, None])
    if args.validation:
        write_embeddings(out, validation_annotations(), embed)


if __name__ == "__main__":
    main()
