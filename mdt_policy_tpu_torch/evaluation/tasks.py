"""CALVIN symbolic task model: the 34 tasks' pre/post-conditions and their
uniqueness categories (copy of `mdt_policy_tpu/evaluation/tasks.py`).

Semantics follow the reference's task table
(`mdt/evaluation/multistep_sequences.py:17-260`); here the per-color block
tasks are generated programmatically instead of being written out 34 times —
one loop over (red, blue, pink) yields identical condition/effect dicts.

A task is a list of alternative (condition, effect) clauses; a clause fires
when every condition key matches the symbolic scene state (list values mean
set membership). Categories enforce "5 distinct task families per chain".
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

State = Dict[str, Union[str, int]]
Clause = Dict[str, Dict]

COLORS = ("red", "blue", "pink")
SLIDER_SIDES = ("right", "left")


def _clause(condition: dict, effect: dict) -> Clause:
    return {"condition": condition, "effect": effect}


def _build_tasks() -> Dict[str, List[Clause]]:
    t: Dict[str, List[Clause]] = {}

    for c in COLORS:
        blk = f"{c}_block"
        # rotate / push: block on table, hand free; block stays on table
        for verb in ("rotate", "push"):
            for direction in ("right", "left"):
                t[f"{verb}_{c}_block_{direction}"] = [
                    _clause({blk: "table", "grasped": 0}, {blk: "table"})]
        # lift from table
        t[f"lift_{c}_block_table"] = [
            _clause({blk: "table", "grasped": 0}, {blk: "grasped", "grasped": 1})]
        # lift from slider: block must be in the compartment the slider exposes
        t[f"lift_{c}_block_slider"] = [
            _clause({blk: "slider_left", "slider": "right", "grasped": 0},
                    {blk: "grasped", "grasped": 1}),
            _clause({blk: "slider_right", "slider": "left", "grasped": 0},
                    {blk: "grasped", "grasped": 1}),
        ]
        # lift from (open) drawer
        t[f"lift_{c}_block_drawer"] = [
            _clause({blk: "drawer", "drawer": "open", "grasped": 0},
                    {blk: "grasped", "grasped": 1})]

    t["move_slider_left"] = [_clause({"slider": "right", "grasped": 0}, {"slider": "left"})]
    t["move_slider_right"] = [_clause({"slider": "left", "grasped": 0}, {"slider": "right"})]
    t["open_drawer"] = [_clause({"drawer": "closed", "grasped": 0}, {"drawer": "open"})]
    t["close_drawer"] = [_clause({"drawer": "open", "grasped": 0}, {"drawer": "closed"})]

    # place the held block into the exposed slider compartment / open drawer
    t["place_in_slider"] = [
        _clause({f"{c}_block": "grasped", "slider": side, "grasped": 1},
                {f"{c}_block": f"slider_{side}", "grasped": 0})
        for c in COLORS for side in SLIDER_SIDES]
    t["place_in_drawer"] = [
        _clause({f"{c}_block": "grasped", "drawer": "open", "grasped": 1},
                {f"{c}_block": "drawer", "grasped": 0})
        for c in COLORS]

    # stack held block onto another block lying on the table
    t["stack_block"] = [
        _clause({f"{top}_block": "grasped", f"{bot}_block": "table", "grasped": 1},
                {f"{top}_block": "stacked_top", f"{bot}_block": "stacked_bottom",
                 "grasped": 0})
        for top in COLORS for bot in COLORS if top != bot]
    t["unstack_block"] = [
        _clause({f"{top}_block": "stacked_top", f"{bot}_block": "stacked_bottom",
                 "grasped": 0},
                {f"{top}_block": "table", f"{bot}_block": "table"})
        for top in COLORS for bot in COLORS if top != bot]

    t["turn_on_lightbulb"] = [_clause({"lightbulb": 0, "grasped": 0}, {"lightbulb": 1})]
    t["turn_off_lightbulb"] = [_clause({"lightbulb": 1, "grasped": 0}, {"lightbulb": 0})]
    t["turn_on_led"] = [_clause({"led": 0, "grasped": 0}, {"led": 1})]
    t["turn_off_led"] = [_clause({"led": 1, "grasped": 0}, {"led": 0})]

    # push a table block into the open drawer; requires the other two blocks
    # stowed in the slider
    in_slider = ["slider_right", "slider_left"]
    t["push_into_drawer"] = [
        _clause({f"{c}_block": "table",
                 **{f"{o}_block": in_slider for o in COLORS if o != c},
                 "drawer": "open", "grasped": 0},
                {f"{c}_block": "drawer", "grasped": 0})
        for c in COLORS]
    return t


def _build_categories() -> Dict[str, int]:
    """(ref multistep_sequences.py:17-52) — task family ids for chain diversity."""
    cat: Dict[str, int] = {}
    for c in COLORS:
        for verb in ("rotate", "push"):
            for d in ("right", "left"):
                cat[f"{verb}_{c}_block_{d}"] = 1
        cat[f"lift_{c}_block_table"] = 4
        cat[f"lift_{c}_block_slider"] = 5
        cat[f"lift_{c}_block_drawer"] = 6
    cat["move_slider_left"] = cat["move_slider_right"] = 2
    cat["open_drawer"] = cat["close_drawer"] = 3
    cat["place_in_slider"] = cat["place_in_drawer"] = 7
    for name in ("turn_on_lightbulb", "turn_off_lightbulb", "turn_on_led", "turn_off_led"):
        cat[name] = 8
    cat["push_into_drawer"] = 9
    cat["stack_block"] = 10
    cat["unstack_block"] = 11
    return cat


TASKS: Dict[str, List[Clause]] = _build_tasks()
TASK_CATEGORIES: Dict[str, int] = _build_categories()

# the reference's dict ordering matters for np.random.choice determinism:
# rotate*, push* (per color pair-ordered), then slider/drawer, lifts, places,
# stack/unstack, lights, push_into_drawer (multistep_sequences.py:54-260)
_REFERENCE_ORDER: Tuple[str, ...] = (
    "rotate_red_block_right", "rotate_red_block_left",
    "rotate_blue_block_right", "rotate_blue_block_left",
    "rotate_pink_block_right", "rotate_pink_block_left",
    "push_red_block_right", "push_red_block_left",
    "push_blue_block_right", "push_blue_block_left",
    "push_pink_block_right", "push_pink_block_left",
    "move_slider_left", "move_slider_right",
    "open_drawer", "close_drawer",
    "lift_red_block_table", "lift_red_block_slider", "lift_red_block_drawer",
    "lift_blue_block_table", "lift_blue_block_slider", "lift_blue_block_drawer",
    "lift_pink_block_table", "lift_pink_block_slider", "lift_pink_block_drawer",
    "place_in_slider", "place_in_drawer",
    "stack_block", "unstack_block",
    "turn_on_lightbulb", "turn_off_lightbulb", "turn_on_led", "turn_off_led",
    "push_into_drawer",
)
TASKS = {name: TASKS[name] for name in _REFERENCE_ORDER}
assert set(TASKS) == set(TASK_CATEGORIES)
