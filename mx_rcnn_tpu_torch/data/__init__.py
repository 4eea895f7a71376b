"""Image files, staging and device prep, the synthetic and PASCAL VOC
datasets, the roidb and the loaders."""
