"""Span-string grammar: repair, parse, and convert generated moment strings.

The model emits moments as text, e.g. ``"[[12, 31], [40, 51]]"``.  These
functions pin the exact repair/parse semantics the metrics depend on; they
match the reference ``lavis/models/blip2_mr_models/utils.py:18-341``
(post_process / moment_str_to_list / tal_str_to_list /
convert_to_absolute_time) decision-for-decision.
"""

from __future__ import annotations

import ast
import re


def post_process(pred: str) -> str:
    """Repair a generated span string into ``"[[s, e], ...]"`` form.

    Rules (in order): truncate at ``</s>``; must look like a nested list or
    return ``"[[-1, -1]]"``; split windows at whitespace before ``[``; drop
    trailing commas; insert a missing comma between two digits; collapse
    repeated commas; swap a reversed integer pair.
    """
    pred = pred.split("</s>")[0]

    if not re.match(r"\[\[.*\]\]", pred):
        return "[[-1, -1]]"

    # strip the outermost brackets: "[[0, 1], [4, 7]]" -> "[0, 1], [4, 7]"
    pred = pred[1:-1]

    windows = re.split(r"\s+(?=\[)", pred)

    output = []
    for window in windows:
        window = re.sub(r",+$", "", window)
        window = re.sub(r"(\d) (\d)", r"\1, \2", window)
        window = re.sub(r",+", ",", window)

        numbers = re.findall(r"\d+", window)
        if len(numbers) == 2:
            t_start, t_end = numbers
            if int(t_start) > int(t_end):
                window = "[" + t_end + ", " + t_start + "]"

        output.append(window)

    return "[" + ", ".join(output) + "]"


def moment_str_to_list(m: str) -> list:
    """Parse a span string to a nested list; malformed input -> ``[[-1, -1]]``.

    Sublists that do not have exactly 2 elements are replaced by ``[-1, -1]``.
    """
    if m == "[[-1, -1]]":
        return [[-1, -1]]
    if not re.match(r"\[\[.*\]\]", m):
        return [[-1, -1]]
    try:
        _m = ast.literal_eval(m)
    except Exception:
        return [[-1, -1]]
    if not isinstance(_m, list):
        return [[-1, -1]]
    for i in range(len(_m)):
        if len(_m[i]) != 2:
            _m[i] = [-1, -1]
    return _m


def tal_str_to_list(m: str) -> list:
    """Parse a TAL span+label string; malformed input -> ``[[-1, -1, -1]]``."""
    if m == "[[-1, -1, -1]]":
        return [[-1, -1, -1]]
    if not re.match(r"\[\[.*\]\]", m):
        return [[-1, -1, -1]]
    try:
        _m = ast.literal_eval(m)
    except Exception:
        return [[-1, -1, -1]]
    if not isinstance(_m, list):
        return [[-1, -1, -1]]
    for i in range(len(_m)):
        if len(_m[i]) != 3:
            _m[i] = [-1, -1, -1]
    return _m


def convert_to_absolute_time(prediction, duration, input_time_format):
    """Convert relative span strings to absolute seconds, as strings.

    ``relative_integers`` are percentages of the duration (0-100);
    ``relative_floats`` are fractions (0-1).  ``[-1, -1]`` sentinels pass
    through unchanged.  Returns one stringified nested list per input.
    """
    assert input_time_format in ("relative_integers", "relative_floats"), (
        "This function is only used for relative timestamps"
    )

    prediction = [moment_str_to_list(m) for m in prediction]

    absolute_prediction = []
    for pred, dur in zip(prediction, duration):
        if input_time_format == "relative_integers":
            absolute_prediction.append(
                [
                    (
                        [
                            round((float(start) / 100) * dur, 2),
                            round((float(end) / 100) * dur, 2),
                        ]
                        if start != -1 and end != -1
                        else [-1, -1]
                    )
                    for start, end in pred
                ]
            )
        else:
            absolute_prediction.append(
                [
                    (
                        [round(float(start) * dur, 2), round(float(end) * dur, 2)]
                        if start != -1 and end != -1
                        else [-1, -1]
                    )
                    for start, end in pred
                ]
            )

    return [str(m) for m in absolute_prediction]
