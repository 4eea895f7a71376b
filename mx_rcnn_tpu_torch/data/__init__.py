"""Image staging and device prep, the synthetic dataset, the roidb and
the training loader."""
