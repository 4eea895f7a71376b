"""mx_rcnn_tpu_torch — the PyTorch/CUDA port of ``mx_rcnn_tpu`` for NVIDIA
Hopper (H100).

Same layout as the JAX package (``ops/``, ``kernels/``, ``models/``,
``eval/``, ``data/``, ``train/``, ``utils/``), own copies of everything it
needs: nothing here imports ``jax``, ``flax``, ``cv2`` or ``mx_rcnn_tpu``.
Inference runs from raw RGB ``uint8`` images to detection records:
``data.image`` → ``eval.tester.Predictor`` → ``eval.tester.im_detect`` →
``ops.postprocess.per_class_nms`` → ``detections_to_records``.  End-to-end
training runs ``data.loader.AnchorLoader`` → ``train.trainer.fit``
(``python -m mx_rcnn_tpu_torch.train_end2end``, synthetic data or a VOC
devkit).  Evaluation runs ``data.pascal_voc.PascalVOC`` →
``data.loader.TestLoader`` → ``eval.tester.pred_eval`` (host or device
post-process, serial or overlapped) → mAP (``python -m
mx_rcnn_tpu_torch.test``).  The hand-written
kernels are the bitmask NMS (``kernels/nms_cuda.py``,
``csrc/nms_bitmask.cu``) and the fused anchor-assign reductions
(``kernels/assign_cuda.py``, ``csrc/assign_iou.cu``), built with ``nvcc``
on first use.  Entry points run on the card unless given
``device="cpu"``.
"""
