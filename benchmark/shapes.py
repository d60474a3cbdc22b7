"""Map sizes of a strided conv stack, from the input size alone."""


def down(n: int, times: int) -> int:
    """Size after ``times`` stride-2 convs with 'same' padding (ceil)."""
    for _ in range(times):
        n = -(-n // 2)
    return n


def make_divisible(v: float, divisor: int = 8) -> int:
    """The MobileNet channel rounding (squeeze widths of the SE units)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def token_in(name: str, kernels) -> bool:
    """Is one of ``kernels`` a whole word of the traced operation's name?"""
    import re

    return bool(set(kernels).intersection(re.findall(r"\w+", name)))
