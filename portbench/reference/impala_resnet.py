"""The deep IMPALA network (Espeholt et al. 2018, arXiv:1802.01561, Fig. 3)
with its LSTM core, in plain PyTorch.

Frames [T, B, H, W, C] uint8 scaled by 1/255; per section of `channels`:
a 3x3 convolution (pad 1), a 3x3 max-pool of stride 2 (pad 1), then two
residual blocks x + conv(relu(conv(relu(x)))); then relu, the features
flattened in (H, W, C) order, a fully connected layer of `fc` with relu;
the clipped reward joins the core input; an LSTM of `lstm_hidden`; the
policy logits and the baseline are linear in the core output.
"""

import torch
import torch.nn.functional as F

from portbench import yardstick
from portbench.reference import lstm


def _pooled(n: int) -> int:
    return (n + 2 - 3) // 2 + 1


def param_shapes(net, frame_shape, num_actions):
    h, w, c = frame_shape
    shapes = []
    for i, ch in enumerate(net["channels"]):
        shapes += [(f"trunk.feat_conv_{i}.weight", (ch, c, 3, 3)),
                   (f"trunk.feat_conv_{i}.bias", (ch,))]
        for j in range(2):
            for k in (1, 2):
                shapes += [(f"trunk.res_{i}_{j}_conv{k}.weight",
                            (ch, ch, 3, 3)),
                           (f"trunk.res_{i}_{j}_conv{k}.bias", (ch,))]
        c, h, w = ch, _pooled(h), _pooled(w)
    hidden = net["lstm_hidden"]
    shapes += [("trunk.fc.weight", (net["fc"], h * w * c)),
               ("trunk.fc.bias", (net["fc"],))]
    shapes += lstm.param_shapes("head.core.", net["fc"] + 1, hidden,
                                net["lstm_layers"])
    shapes += [("head.policy.weight", (num_actions, hidden)),
               ("head.policy.bias", (num_actions,)),
               ("head.baseline.weight", (1, hidden)),
               ("head.baseline.bias", (1,))]
    return shapes


def pools(net, frame_shape):
    """(channels, height, width) of each max-pool's input."""
    h, w, _ = frame_shape
    out = []
    for ch in net["channels"]:
        out.append((ch, h, w))
        h, w = _pooled(h), _pooled(w)
    return out


def forward_flops(net, frame_shape, num_actions):
    """FLOPs of one frame's forward: the convolutions, the fc, one LSTM
    step and the heads (2 a multiply-add; pools and elementwise work not
    counted)."""
    h, w, c = frame_shape
    total = 0
    for ch in net["channels"]:
        total += yardstick.conv_flops(c, ch, 3, h, w)
        h, w = _pooled(h), _pooled(w)
        total += 4 * yardstick.conv_flops(ch, ch, 3, h, w)
        c = ch
    total += 2 * h * w * c * net["fc"]
    total += yardstick.lstm_flops(net["fc"] + 1, net["lstm_hidden"],
                                  net["lstm_layers"])
    return total + 2 * net["lstm_hidden"] * (num_actions + 1)


def state_shapes(net, num_actions, batch_size):
    shape = (net["lstm_layers"], batch_size, net["lstm_hidden"])
    return [shape, shape]


def forward(params, batch, state, net, num_actions):
    """-> (policy logits [T, B, A], baseline [T, B])."""
    frame = batch["frame"]
    T, B = frame.shape[:2]
    x = frame.reshape((T * B,) + tuple(frame.shape[2:]))
    x = x.permute(0, 3, 1, 2).float() / 255.0
    for i in range(len(net["channels"])):
        x = F.conv2d(x, params[f"trunk.feat_conv_{i}.weight"],
                     params[f"trunk.feat_conv_{i}.bias"], padding=1)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for j in range(2):
            y = x
            for k in (1, 2):
                y = F.conv2d(F.relu(y),
                             params[f"trunk.res_{i}_{j}_conv{k}.weight"],
                             params[f"trunk.res_{i}_{j}_conv{k}.bias"],
                             padding=1)
            x = x + y
    x = F.relu(x).permute(0, 2, 3, 1).reshape(T * B, -1)
    x = F.relu(x @ params["trunk.fc.weight"].t() + params["trunk.fc.bias"])
    reward = torch.clamp(batch["reward"].float(), -1, 1).reshape(T * B, 1)
    core_in = torch.cat([x, reward], -1).reshape(T, B, -1)
    notdone = 1.0 - batch["done"].float()
    out, _ = lstm.forward(params, "head.core.", core_in, notdone, state,
                          net["lstm_layers"])
    out = out.reshape(T * B, -1)
    logits = out @ params["head.policy.weight"].t() + params["head.policy.bias"]
    baseline = (out @ params["head.baseline.weight"].t()
                + params["head.baseline.bias"])
    return logits.reshape(T, B, num_actions), baseline.reshape(T, B)
