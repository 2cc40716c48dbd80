"""Kernel B2's share of its roofline in the evaluator's graph replays (%):
the least time of a tick's B2 calls (the denoiser's encoder layers once,
its decoder layers at each sampling step, from their shapes; f32) over
their device time by kernel name."""
from port_bench.harness import flops as Fl
from port_bench.harness.readers import roofline


def read(obs):
    c, N, fam = obs["ctx"].agent_cfg, obs["runner"].N, obs["ctx"].config["family"]
    dh = c.embed_dim // c.n_heads
    n_ctx = 1 + (2 if fam == "mdt" else c.num_latents)
    calls = [(N, c.n_heads, n_ctx, dh, False)] * c.n_enc_layers + \
        [(N, c.n_heads, c.act_window_size, dh, True)] * (c.n_dec_layers * c.num_sampling_steps)
    return roofline(obs, lambda n: "small_seq_mha_kernel" in n,
                    sum(Fl.b2_least_s(*k) for k in calls), len(calls), obs.get("ticks", 0))
