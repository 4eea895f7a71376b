"""``python -m mx_rcnn_tpu_torch.serve``: see ``serve/driver.py``."""

from mx_rcnn_tpu_torch.serve.driver import main, parse_args

if __name__ == "__main__":
    main(parse_args())
