"""Task -> language annotation table and oracle task definitions (port of
`mdt_policy_tpu/evaluation/annotations.py`).

The reference evaluates each CALVIN subtask with a FIXED validation sentence
(conf/annotations/new_playtable_validation.yaml, consumed at
rollout_long_horizon.py:129-138 and evaluation/utils.py:219-240). Evaluating
with any other text (e.g. the task name with underscores stripped) silently
shifts the goal-text distribution and degrades CALVIN success rates — so the
table is vendored as package data under mdt_policy_tpu_torch/conf/ (a copy
of the JAX package's). The 389-sentence training table is not: nothing of
the port reads it yet.

Also vendored: the symbolic task definitions the calvin_env task oracle is
built from (conf/callbacks/rollout/tasks/new_playtable_tasks.yaml — the
reference hydra-instantiates `calvin_env.envs.tasks.Tasks` with this dict).
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Callable, Dict, List, Optional

_CONF = Path(__file__).resolve().parent.parent / "conf"

__all__ = [
    "validation_annotations",
    "task_definitions",
    "make_task_oracle",
    "make_goal_fn",
]


def _load_yaml(path: Path):
    import yaml

    return yaml.safe_load(path.read_text())


@functools.lru_cache(maxsize=None)
def validation_annotations(name: str = "new_playtable") -> Dict[str, List[str]]:
    """task -> [validation sentence] (exactly one per task)."""
    return _load_yaml(_CONF / "annotations" / f"{name}_validation.yaml")


@functools.lru_cache(maxsize=None)
def task_definitions(name: str = "new_playtable_tasks") -> Dict[str, list]:
    """task -> [base_task_fn, *args] for the calvin_env oracle."""
    return _load_yaml(_CONF / "tasks" / f"{name}.yaml")


def make_task_oracle(name: str = "new_playtable_tasks"):
    """Build the calvin_env task oracle with the vendored definitions
    (ref: hydra instantiation of conf/callbacks/rollout/tasks/*.yaml).
    Raises ImportError when calvin_env is absent."""
    from calvin_env.envs.tasks import Tasks  # external dependency

    return Tasks(task_definitions(name))


def make_goal_fn(
    context_length: int,
    *,
    lang_embeddings=None,
    annotations: Optional[Dict[str, List[str]]] = None,
) -> Callable[[str], Dict]:
    """Goal factory for the rollout loops: subtask -> goal dict.

    Uses the task's reference VALIDATION sentence (never a synthesized string).
    Two goal encodings, mirroring the reference's `use_text_not_embedding`
    switch (mdt_agent.py:360-363):

    * default: raw text tokenized for the in-program CLIP text tower
      (`lang_tokens`, the use_text_not_embedding=True path);
    * `lang_embeddings` given (a LangEmbeddings instance over the dataset's
      precomputed embeddings.npy): the stored embedding is passed through as
      `lang` (the use_text_not_embedding=False path, evaluation/utils.py:219-240).
    """
    from ..utils.clip_tokenizer import tokenize

    table = annotations if annotations is not None else validation_annotations()

    def goal_fn(subtask: str) -> Dict:
        sentences = table.get(subtask)
        if not sentences:
            raise KeyError(
                f"no annotation for task {subtask!r}; known: {sorted(table)[:5]}...")
        text = sentences[0]
        goal = {"lang_text": text}
        if lang_embeddings is not None:
            goal.update(lang_embeddings.get_lang_goal(text))
        else:
            goal["lang_tokens"] = tokenize(text, context_length)
        return goal

    return goal_fn
