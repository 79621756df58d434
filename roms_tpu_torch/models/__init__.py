"""Analytic model cases (counterparts of ``roms_tpu.models``)."""
