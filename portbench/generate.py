"""The inputs of a run, drawn from its seed on the run's device: the
weights, the rollouts and the initial agent states. The same seed gives
the same inputs; every seed gives the same shapes."""

import math

import torch

# One stream of random numbers per kind of input.
WEIGHTS, ROLLOUTS, STATES = 1, 2, 3


def stream(seed: int, kind: int) -> int:
    """A generator seed for one kind of input of a run's seed."""
    return (seed * 0x9E3779B97F4A7C15 + kind) % (2 ** 63)


def _generator(seed: int, kind: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, kind))


def weights(shapes, seed: int, device):
    """{name: float32 tensor} for [(name, shape)]: one normal draw for the
    whole tree, each matrix or kernel scaled by 1/sqrt(its fan-in), each
    vector by 0.1."""
    gen = _generator(seed, WEIGHTS, device)
    sizes = [math.prod(shape) for _, shape in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), piece in zip(shapes, flat.split(sizes)):
        scale = (1.0 / math.sqrt(math.prod(shape[1:])) if len(shape) > 1
                 else 0.1)
        out[name] = (piece * scale).reshape(shape)
    return out


def rollouts(traffic, config, seed: int, device):
    """traffic["rollouts"] distinct [T+1, B] learner batches: uint8 frames,
    normal rewards, returns and behaviour outputs, dones at
    traffic["done_probability"], uniform actions."""
    gen = _generator(seed, ROLLOUTS, device)
    shape = (traffic["unroll_length"] + 1, traffic["batch_size"])
    actions = config["num_actions"]
    kw = dict(generator=gen, device=device)
    out = []
    for _ in range(traffic["rollouts"]):
        out.append({
            "frame": torch.randint(0, 256, shape + tuple(config["frame_shape"]),
                                   dtype=torch.uint8, **kw),
            "reward": torch.randn(shape, **kw),
            "done": torch.rand(shape, **kw) < traffic["done_probability"],
            "episode_return": torch.randn(shape, **kw),
            "episode_step": torch.randint(0, traffic["episode_step_high"],
                                          shape, dtype=torch.int32, **kw),
            "last_action": torch.randint(0, actions, shape, **kw),
            "action": torch.randint(0, actions, shape, **kw),
            "policy_logits": torch.randn(shape + (actions,), **kw),
            "baseline": torch.randn(shape, **kw),
        })
    return out


def states(state_shapes, traffic, seed: int, device):
    """One initial agent state a rollout: a tuple of normal tensors of
    `state_shapes`, scaled by traffic["state_scale"]."""
    gen = _generator(seed, STATES, device)
    scale = traffic["state_scale"]
    return [tuple(torch.randn(shape, generator=gen, device=device) * scale
                  for shape in state_shapes)
            for _ in range(traffic["rollouts"])]
