"""The port's served INT8 ResNet-CIFAR request: calibrated on the
calibration batch by the port's ``quant.calibrate_resnet``, the weights
programmed once, each request replayed from a CUDA graph
(``executor.int8_request``: ``GraphedExecute`` on the card)."""


def request(cfg, params, calib):
    from repro_torch.models import quant
    from repro_torch.models.cnn import executor, graphs
    port_cfg = {"name": cfg["model"], "stem_width": cfg["stem_width"],
                "stage_widths": tuple(cfg["stage_widths"]),
                "blocks_per_stage": tuple(cfg["blocks_per_stage"]),
                "num_classes": cfg["num_classes"],
                "image_hw": tuple(cfg["image_hw"])}
    scales = quant.calibrate_resnet(params, calib, port_cfg)
    return executor.int8_request(graphs.build_resnet_graph(port_cfg), params,
                                 scales)
