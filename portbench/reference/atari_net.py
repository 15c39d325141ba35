"""The shallow Atari network (the Nature DQN trunk of Mnih et al. 2015, as
torchbeast monobeast's AtariNet) with its LSTM core, in plain PyTorch.

Frames [T, B, H, W, C] uint8 scaled by 1/255; convolutions of 32 8x8
stride 4, 64 4x4 stride 2 and 64 3x3 stride 1, each unpadded and followed
by relu; the features flattened in (H, W, C) order; a fully connected
layer of `fc` with relu. The core input is that, the clipped reward and
the one-hot last action (width fc + 1 + A); the LSTM keeps that width
over `lstm_layers` layers; the policy logits and the baseline are linear
in its output.
"""

import torch
import torch.nn.functional as F

from portbench import yardstick
from portbench.reference import lstm

CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))  # (channels, kernel, stride)


def core_width(net, num_actions):
    return net["fc"] + 1 + num_actions


def param_shapes(net, frame_shape, num_actions):
    h, w, c = frame_shape
    shapes = []
    for i, (ch, k, s) in enumerate(CONVS):
        shapes += [(f"Conv_{i}.weight", (ch, c, k, k)),
                   (f"Conv_{i}.bias", (ch,))]
        c, h, w = ch, (h - k) // s + 1, (w - k) // s + 1
    shapes += [("Dense_0.weight", (net["fc"], h * w * c)),
               ("Dense_0.bias", (net["fc"],))]
    width = core_width(net, num_actions)
    shapes += lstm.param_shapes("head.core.", width, width,
                                net["lstm_layers"])
    shapes += [("head.policy.weight", (num_actions, width)),
               ("head.policy.bias", (num_actions,)),
               ("head.baseline.weight", (1, width)),
               ("head.baseline.bias", (1,))]
    return shapes


def forward_flops(net, frame_shape, num_actions):
    """FLOPs of one frame's forward: the convolutions, the fc, one step
    of the LSTM and the heads (2 a multiply-add; elementwise work not
    counted)."""
    h, w, c = frame_shape
    total = 0
    for ch, k, s in CONVS:
        h, w = (h - k) // s + 1, (w - k) // s + 1
        total += yardstick.conv_flops(c, ch, k, h, w)
        c = ch
    total += 2 * h * w * c * net["fc"]
    width = core_width(net, num_actions)
    total += yardstick.lstm_flops(width, width, net["lstm_layers"])
    return total + 2 * width * (num_actions + 1)


def state_shapes(net, num_actions, batch_size):
    shape = (net["lstm_layers"], batch_size, core_width(net, num_actions))
    return [shape, shape]


def forward(params, batch, state, net, num_actions):
    """-> (policy logits [T, B, A], baseline [T, B])."""
    frame = batch["frame"]
    T, B = frame.shape[:2]
    x = frame.reshape((T * B,) + tuple(frame.shape[2:]))
    x = x.permute(0, 3, 1, 2).float() / 255.0
    for i, (_, _, s) in enumerate(CONVS):
        x = F.relu(F.conv2d(x, params[f"Conv_{i}.weight"],
                            params[f"Conv_{i}.bias"], stride=s))
    x = x.permute(0, 2, 3, 1).reshape(T * B, -1)
    x = F.relu(x @ params["Dense_0.weight"].t() + params["Dense_0.bias"])
    reward = torch.clamp(batch["reward"].float(), -1, 1).reshape(T * B, 1)
    action = F.one_hot(batch["last_action"].reshape(T * B).long(),
                       num_actions).float()
    core_in = torch.cat([x, reward, action], -1).reshape(T, B, -1)
    notdone = 1.0 - batch["done"].float()
    out, _ = lstm.forward(params, "head.core.", core_in, notdone, state,
                          net["lstm_layers"])
    out = out.reshape(T * B, -1)
    logits = out @ params["head.policy.weight"].t() + params["head.policy.bias"]
    baseline = (out @ params["head.baseline.weight"].t()
                + params["head.baseline.bias"])
    return logits.reshape(T, B, num_actions), baseline.reshape(T, B)
