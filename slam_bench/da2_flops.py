"""Depth Anything V2 Small's FLOPs a frame, from its shapes: the
benchmark's own count, for `networks/da2_small.py` (`frame_mfu`) and the
`depth_*` metrics.

FLOPs = 2 * MACs of every matmul and convolution; normalisation,
activations, softmax, resizes and the input's preparation are left out.
At the published input of a 480x640 frame (518x686, 37x49 patches,
1,814 tokens with the cls token): patch embedding 0.82 GFLOPs, the
blocks' linear layers 77.03, their attention 60.65 (4 N^2 64 a head and
block: Q K^T and the product with V), the DPT head 28.96; 167.47 in all.
"""

from __future__ import annotations

from slam_bench.reference.depth_anything import INPUT_SIZE, PATCH, WIDTH, input_shape

BLOCKS = 12
FEATURES = 64
OUT_CHANNELS = (48, 96, 192, 384)


def parts(height: int, width: int, size: int = INPUT_SIZE) -> dict:
    """{patch_embed, linear, attention, head: FLOPs} of one frame of
    height x width (the camera's), at the network's input."""
    h, w = input_shape(height, width, size)
    gh, gw = h // PATCH, w // PATCH
    n, c = gh * gw + 1, WIDTH

    def conv(cin, cout, k, pixels):
        return 2.0 * cin * cout * k * k * pixels

    g4, g2, g1 = 16 * gh * gw, 4 * gh * gw, gh * gw
    g8 = ((gh + 1) // 2) * ((gw + 1) // 2)  # the 3x3 stride-2 conv's output
    f = FEATURES
    head = sum(conv(c, oc, 1, g1) for oc in OUT_CHANNELS)
    head += conv(48, 48, 4, g1) + conv(96, 96, 2, g1) + conv(384, 384, 3, g8)
    head += sum(conv(oc, f, 3, px) for oc, px in zip(OUT_CHANNELS, (g4, g2, g1, g8)))
    rcu = 2 * conv(f, f, 3, 1)
    head += rcu * g8 + conv(f, f, 1, g1)  # refinenet4: one unit, out_conv after the resize
    head += 2 * rcu * g1 + conv(f, f, 1, g2)
    head += 2 * rcu * g2 + conv(f, f, 1, g4)
    head += 2 * rcu * g4 + conv(f, f, 1, 4 * g4)
    head += conv(f, f // 2, 3, 4 * g4) + conv(f // 2, 32, 3, h * w) + conv(32, 1, 1, h * w)
    return dict(patch_embed=conv(3, c, PATCH, g1),
                linear=BLOCKS * 2.0 * n * c * (3 * c + c + 4 * c + 4 * c),
                attention=BLOCKS * 4.0 * n * n * c,
                head=head)


def flops_per_frame(height: int, width: int, size: int = INPUT_SIZE) -> float:
    return float(sum(parts(height, width, size).values()))


def attention_flops_per_frame(height: int, width: int, size: int = INPUT_SIZE) -> float:
    return float(parts(height, width, size)["attention"])
