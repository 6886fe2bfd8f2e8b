"""Spectrometer QC masks (reference: spectrometer_masks/masks_sds.py)."""
