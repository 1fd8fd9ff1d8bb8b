"""The port's served YOLOv8n request: the conv weights and the decode's
constants laid out once, each request replayed from a CUDA graph
(``yolo.request``: ``GraphedForward`` on the card), decoded output."""


def request(cfg, params, calib):
    from repro_torch.models.cnn import yolo
    return yolo.request(params, tuple(cfg["image_hw"]))
