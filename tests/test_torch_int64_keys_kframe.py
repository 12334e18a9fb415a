"""The port's represent steps on int64 binning keys (512x512, 2^20
slots, a 21-bit gauss field) against the plain float64 reference: a K-frame under removal control
(`int64_keys_fit.py` holds the case and its tolerances)."""

from int64_keys_fit import check_steps, four_threads  # noqa: F401


def test_int64_key_steps_match_the_float64_reference(four_threads):  # noqa: F811
    check_steps("K")
