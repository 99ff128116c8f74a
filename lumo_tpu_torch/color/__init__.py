"""Spectral color: dense spectra, hero wavelengths, RGB uplift, color spaces."""
