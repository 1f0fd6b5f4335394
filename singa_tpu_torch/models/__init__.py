"""Model zoo (counterpart of singa_tpu/models/): the MLP, the GPT
decoder, the transformer encoder and BERT, the Char-RNN LSTM, and the
CNNs of the reference's CIFAR-10 and ImageNet trainers (AlexNet, VGG,
the ResNets, MobileNetV1 and Xception)."""

from singa_tpu_torch.models.alexnet import (  # noqa: F401
    AlexNet, CifarAlexNet, alexnet, alexnet_cifar)
from singa_tpu_torch.models.char_rnn import CharRNN  # noqa: F401
from singa_tpu_torch.models.gpt import (  # noqa: F401
    GPT, gpt_draft, gpt_medium, gpt_small, unstack_params)
from singa_tpu_torch.models.mlp import MLP  # noqa: F401
from singa_tpu_torch.models.mobilenet import (  # noqa: F401
    MobileNetV1, mobilenet_v1, mobilenet_v1_cifar)
from singa_tpu_torch.models.resnet import (  # noqa: F401
    BasicBlock, Bottleneck, CifarResNet, ResNet, resnet18, resnet20_cifar,
    resnet32_cifar, resnet34, resnet50, resnet56_cifar, resnet101, resnet152)
from singa_tpu_torch.models.transformer import (  # noqa: F401
    Bert, BertForClassification, MultiHeadAttention, TransformerEncoder,
    TransformerEncoderLayer, bert_base, bert_small, collect_moe_aux)
from singa_tpu_torch.models.vgg import (  # noqa: F401
    VGG, vgg11, vgg13, vgg16, vgg16_cifar, vgg19)
from singa_tpu_torch.models.xception import (  # noqa: F401
    Xception, xception, xception_cifar)

__all__ = [
    "MLP", "GPT", "gpt_draft", "gpt_medium", "gpt_small", "unstack_params",
    "MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder",
    "Bert", "BertForClassification", "bert_base", "bert_small",
    "collect_moe_aux", "CharRNN",
    "AlexNet", "CifarAlexNet", "alexnet", "alexnet_cifar",
    "VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg16_cifar",
    "ResNet", "CifarResNet", "BasicBlock", "Bottleneck",
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "resnet20_cifar", "resnet32_cifar", "resnet56_cifar",
    "MobileNetV1", "mobilenet_v1", "mobilenet_v1_cifar",
    "Xception", "xception", "xception_cifar",
]
