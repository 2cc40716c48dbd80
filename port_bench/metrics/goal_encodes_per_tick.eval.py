"""Text-tower encodes a tick of the batched evaluator: the change of B1's
launch counter over the window over the tower's layers over the ticks (in
this configuration only the eager text tower launches B1 after capture)."""


def read(obs):
    ticks = obs.get("ticks")
    if not ticks or not obs.get("b1_launches"):
        return None
    return obs["b1_launches"] / obs["text_layers"] / ticks
