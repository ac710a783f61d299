"""The serving steps of the reference's ``repro/train``: prefill and decode."""
