"""Vision model zoo (port of `mxnet_tpu/gluon/model_zoo/vision/`): ResNet
V1 and V2 at depths 18-152, with the get_model registry. The other
families (alexnet, densenet, inception, mobilenet, squeezenet, vgg) are
not ported yet (ROADMAP.md, queue 1)."""
from .resnet import (ResNetV1, ResNetV2, BasicBlockV1, BasicBlockV2,
                     BottleneckV1, BottleneckV2, resnet18_v1, resnet34_v1,
                     resnet50_v1, resnet101_v1, resnet152_v1, resnet18_v2,
                     resnet34_v2, resnet50_v2, resnet101_v2, resnet152_v2,
                     get_resnet)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
}


def get_model(name, **kwargs):
    name = name.lower()
    if name not in _models:
        raise ValueError(
            "Model %s is not supported. Available options are\n\t%s"
            % (name, "\n\t".join(sorted(_models.keys()))))
    return _models[name](**kwargs)
