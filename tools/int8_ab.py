#!/usr/bin/env python3
"""Time the port's int8 matmul (K5) and the int8 models it serves, for
one or more source trees, in turns, on one card.

    python3 tools/int8_ab.py SRC [SRC ...]

Each ``SRC`` is a directory holding a ``repro_torch`` package (``src``
of this checkout, or of another commit unpacked with ``git archive``).
Each runs in its own process, in the order given, so a change and its
parent compare within one call as parent, change, change, parent:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python3 tools/int8_ab.py build/parent/src src src build/parent/src

One JSON line per tree. For every shape of ``chip_smoke.py``'s
``INT8_SHAPES`` (M, K, N), ``"int8_matmul <M>x<K>x<N> <type>"``: [warm
ms, cold ms, bit-exact against the plain version], taken as
``chip_smoke.timed`` and ``chip_smoke.cold_ms`` take them, in float32
and, for a tree whose kernel writes it, bfloat16 (the model's type). The
weight is laid out as the tree's model holds it: row-major before the
K-major int8 weight, K-major since. End to end, ``"falcon d4 prefill
ms"`` and ``"falcon d4 decode ms/token"`` (Falcon-Mamba-7B d4 at full
size) and the same for the edge ladder's d4, each a list of ``REPS``
readings of ``chip_smoke.timed_generate`` (host clock, batch 64, prompt
256, 16 new tokens, cache 512). The card's name and power limit
(``nvidia-smi``) come first. Needs a CUDA device; each tree's kernels
are built into its own ``build`` directory.
"""
import json

from attention_ab import load_tree, serving, turns


def run_tree(src):
    torch, cs = load_tree(src)
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import ref
    k_major = hasattr(im, "k_major")
    types = (torch.float32, torch.bfloat16) if k_major else \
        (torch.float32,)
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"src": src}
    for m, k, n in cs.INT8_SHAPES:
        xq, sx = ref.quantize_ref(torch.randn((m, k), generator=g,
                                              device="cuda"))
        wq, sw = ref.quantize_ref(torch.randn((k, n), generator=g,
                                              device="cuda"), dim=0)
        if k_major:
            wq = im.k_major(wq)
        for dt in types:
            args = (xq, sx, wq, sw) + ((dt,) if k_major else ())

            def f():
                return im.int8_matmul_cuda(*args)
            exact = torch.equal(f(), ref.int8_matmul_ref(xq, sx, wq, sw)
                                .to(dt))
            ms, _, _ = cs.timed(f)
            out[f"int8_matmul {m}x{k}x{n} {str(dt)[6:]}"] = [
                ms, cs.cold_ms(f), exact]
    serving(torch, cs, out, "falcon-mamba-7b", ("d4",), "falcon")
    serving(torch, cs, out, "edge-ladder", ("d4",), "edge")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    turns(__file__, run_tree, timeout=1500)
