from lednet_tpu_torch.apis.inference import inference_model, init_model
