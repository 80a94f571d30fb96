"""The port's host Bayer-Groth arguments against the JAX package, on the CPU.

- The zero, single-value-product, Hadamard, product and multi-exponentiation
  arguments at the inputs of `tests/test_arguments.py` (`GameRng(31337)`,
  M = 3 rows of n = 4, the draws in that file's order): each proof equals
  the JAX one field for field (its fields as compressed points, 32-byte
  scalars and length-prefixed lists), verifies in the port, and a tampered
  one raises.
- `ShuffleArgument` at (m, n) = (2, 2) with the key ceremony of
  `tests/test_api.py::test_shuffle_argument_adapter_roundtrip` (`GameRng(9)`),
  the output deck made by `remask_cards` on the permuted deck: the port's
  `shuffle_to_bytes` equal the JAX package's, the port's host verifier
  accepts the JAX bytes read back by `shuffle_from_bytes`, and a substituted
  output deck raises "Hadamard Product (5.1)". Every combo of its verifier is
  a one-statement MSM of at most 4 points: the gather engine.
- Inside the port, the interop of `tests/test_device_arguments.py`: the
  staged verifier accepts the host proof (`host_proof_to_dev`). The other
  direction, the host verifier on a staged proof (`dev_proof_to_host`), is
  in `tests/test_torch_round.py`, on the proof its round makes.

The JAX values are pinned below; the `slow` test recomputes them live.
Tolerance: exact equality of bytes.
"""

import dataclasses
import re
import struct
import types

import numpy as np
import pytest

from mental_poker_tpu.crypto import proof_io as jproof_io
from mental_poker_tpu_torch.arguments import hadamard, product, zero
from mental_poker_tpu_torch.arguments import multi_exponentiation as me
from mental_poker_tpu_torch.arguments import single_value_product as svp
from mental_poker_tpu_torch.arguments.common import bilinear, com_many, vec_hadamard
from mental_poker_tpu_torch.arguments.shuffle import _as_matrix
from mental_poker_tpu_torch.crypto import elgamal, pedersen, proof_io
from mental_poker_tpu_torch.crypto.errors import HADAMARD, MULTI_EXP, SVP_ARG, ZERO_ARG, ProofVerificationError
from mental_poker_tpu_torch.crypto.serialize import point_to_bytes_compressed, scalar_to_bytes
from mental_poker_tpu_torch.crypto.transcript import SHUFFLE_RNG_SEED, TranscriptBatch
from mental_poker_tpu_torch.models.round import cipher_take
from mental_poker_tpu_torch.ops.curve import stark_curve
from mental_poker_tpu_torch.ops.msm import FixedBaseTable
from mental_poker_tpu_torch.protocol import api
from mental_poker_tpu_torch.protocol.dl_cards import DLCards
from mental_poker_tpu_torch.utils.rand import GameRng

from _torch_bridge import one_torch_thread  # noqa: F401

M, N_ = 3, 4

# JAX proofs of the sub-arguments (`_subarguments` with the JAX package's
# modules), as `_proof_hex` of each proof.
SUBARG_PIN = {
    'zero': (
        "10ce45fabf9773b8e2ef884388596eb93c7ac24c5160d8799a18bd972c591a82"
        "00c8f86d14f541fecafaf2f5a9732230b6a985006e60b9575a177e1168782186"
        "07000000000000005b9fdda66515f758e2e694bda336a98961fb918c84d0ed7e"
        "3e4f7d15bb7dcc8199fb2728879b68a440c61eb706f7ba4f5f4e8701f452d4bf"
        "23c3bce3884e1f07a1712f0b4e1a65a262efca9e29798f25c2b44988681c011c"
        "901471ca3fce6e846ef1e9466d2ede806d5b9fcb8ce0836bd8e9cb6fe8cc6c30"
        "c2ef5fe07fd02680000000000000000000000000000000000000000000000000"
        "0000000000000040d4436333b4f93bd1b62e6701344e5b518f31ba8c03407328"
        "f54f93bdd10fc00282cd94ab20d83fef4f830137f5bb58577888dc675d4d96a7"
        "9cf7637e1b65e2070400000000000000cfb1e7552e8ad0419dfd73925c236745"
        "721fd29164472186784272bc256a77057f141382068e5c12d7fa43ed0641434a"
        "b93917ba59428011e09c4b43226f9a06a6a1e768d9b50b790d08ffebd31aa7d7"
        "5f4fe3f2c18c0007c4db83232b0014029e0e0dc2ee90caff132da486693dff62"
        "b5fe75c008af8a868269bf3e2614d2067f166169265620c915a527cd07dce1eb"
        "5cb632040b05fa9e97ab236a93adf200040000000000000011394bf504888376"
        "5aaaa59b4c13639b9ecfd49d2a82a4f52df38dae9f188e06a67d5068ad0b046a"
        "d5ca976cd3d0b5ec4b7f36da3d9af91bd0809c1eb5f08400f749077e1305ff50"
        "0d4e4ab868be1326fd98be4a353ae3e28d2f88bed93ac20094051fed28dd23d1"
        "48e7b222421be31a9d92261dfe5d4dce8f4e71b3f36c0e024b2a2c2cae16a533"
        "629ef37015d28c1e1aec8748f623d6fa5ded407403327b028190771d36072764"
        "2d3065444e53c0e4b385a653401d18ff41694b803d675e05"
    ),
    'svp': (
        "9a0b4f438851d59af9c2cc63cbc033576696f4aeafd45cc82e1918c060bee901"
        "86e7790430976dc6323fc53e04b6dbeffc59f35309c51c56990d6af87607ab02"
        "d909976384624b38acc799523c87a0ffd633a384ddde23fd66b1d2049c518e00"
        "0400000000000000ec128caa18b1e28238a761bd72be091f661b7aefced73b4a"
        "7b6ddd7530978d02b308bc8af19c9978c25ff81bb66f1567c596c1280e440227"
        "1bf7060815f78e0017ac95be6329e630faaa52cdf09793ced8c7b6fa5afe1bbd"
        "64c070c2c93b96061faea0c3399febd9c7d8484e6967e4e4f12b63a195fbdd77"
        "61c7843596803802f33c9138bc9fab9f29be305e236703025758224a36ce4a36"
        "926e25c8c8c984070400000000000000ec128caa18b1e28238a761bd72be091f"
        "661b7aefced73b4a7b6ddd7530978d0255fb11f6587f1ca947a6bd0f7dac6373"
        "04747b8871ef42ed5c6cd6e2a989400576a057a7fc31db2eb902ca56119a78f5"
        "4c58c3d358172cc54a73e388375c3406475ddab25e4a8e4733d083d137f7f264"
        "b5c6334b8c55690a025955f504416d000a5e46b975fd2902d2bfbdf4bd92cecb"
        "a313ddb311c8bda48b12d4842d6d9d00"
    ),
    'hadamard': (
        "010000000000000045739ac8068edaa04c72b4b23a61c9ef5369774bbbf95856"
        "57ebd265b2cd3c84fafd1662a96f370ec786a8899ff0e0ac6311e536fec9c41d"
        "9502e34da545d98663af80fd12525e83be8912a216226401a634781a795e9676"
        "474b4ee17c1814070700000000000000bcaa768594939407e7d138256c272310"
        "3845b953a1aed23391a5f8c7d8a8f2038129da81dfd0440ac33bfef0165cb19c"
        "1a5667f3ba5e230c35c2c21daa3333858a78de3cecdb01f5e7f62f076c4434a0"
        "ce39f959ea5f5d3d100f502d8295f006e24609667f81f2fa8bbe7f0e115dc7f9"
        "057310e74cc948377a04850660b6930100000000000000000000000000000000"
        "00000000000000000000000000000040d05d61ff036b3b2e31668348aba74b4a"
        "69e0d553cf49c57b5febfd2074f392054776280c65bbbf82b74c138ecd546bfb"
        "4831380bf846881a256d4592e809e38504000000000000007e1b435824c3d6f5"
        "86c745f69c52ba9182602e4d9af420f8e3ec54a8bc9b3502202c618e739f3a86"
        "bf0dda2ca9759bd8e895d2b4f65f7812e2607c180d0e730210340fb1b1e0fb45"
        "da2a0db5a19b9e483cac3df39d2942f6e2778ad16025fd079981e036e4310cca"
        "0ddfaedcede68ecce74efe989eeba34e9493f91a141ed80379f96972cbaa2910"
        "2e18fa7eaa7c02257bc4ada46c733f757889039139cec4060400000000000000"
        "ef602089a1b5c181920ebea04ea6704e8fb6f1a75f2842ea86576ee5d3265806"
        "f595ef195c130df7f389e34d37eb124afdb36b00dc4ab3dadd8175059c82b304"
        "3db0a125d09b92f9981f9c9225f9ec174d55772b50a00cc77d06bb88fcaa1c07"
        "a0922d0c2aadf85d07d0ea1a4d86ea07ace37be0f99ed51f209e9e2166306e05"
        "8c625f1ca0609f3fc712b1a15e3b18145df140aacf59aadbed77edae2c781403"
        "b0dc08ba7dd1fe8b78f143f4405d2a991b9f70057dcdb566812115cda511d407"
    ),
    'product': (
        "86836f541838513ed0920e027e19b3befb60c2318233e38cc52a4214e682ae83"
        "01000000000000005b9a9b29378613c8eab817f1e6eb3efcba0f1b61b8a2e5ce"
        "4e040d5addae30027887c8a701b0c4dc4e18c780900058f0510cd76c18eac3c9"
        "348c4b943bbde180375042f30e7161fab9fa1a06e0dc67090771a01fb9447706"
        "32c29ebeefbc8c82070000000000000082ff0e7cf1c81258afdcd2d770e2b6f3"
        "0313a2fb889c493dcc4f2fdb25e6e38073b74ca9d7909aa7a5671bca611202f6"
        "0d93f2d4f8f14798d5acf412a5054a02fda6a9cbe107cf4377a6494cdecd5670"
        "c39ec6942866ec395294b4481abfd087e6c07ab07d6cac16aede023e02a28da2"
        "b023878f6158a92d8b49804915aa8d0500000000000000000000000000000000"
        "000000000000000000000000000000400feca61370cf30c81d5cded5894cc056"
        "de3407637dbbd11e4a27f8ed0f037e05af0fda72a08efa5e538285102deaca95"
        "4e6172dee8ba35bb26235b74dac4040004000000000000000e098d540a34699a"
        "b421c73d846d0289fc60a1730742ca2f3a21276049d93f068c9141fdf7401c75"
        "e4d0b53292bb650ead82797ecf663545eca0121850c981026efa7cde1ff725f8"
        "e79b76486342043be40e252f5ef7e3de20ef92eed38e4905a2bd189112124b3f"
        "4292cf5c73005d387d21b3f8854c1ac16480e99c0eae5f04c296bd5018d51bad"
        "6a420f51fea57f99fd359fe24bf4e773d5feaf05248a69000400000000000000"
        "1e18b5de2038cbce76d145d3efa59600387f7230ed69c7ea9c341bd9a19fe802"
        "ecf5311920a3718e77a3d9a9e2b623b2352653b765c15e3e433a3a6dfb3c0200"
        "20320835a536f437ac678c73a9bc62d2e96e66e257ef084d3f05335dacecc507"
        "1d44c020726ac496df88846a7d339a12ebb9d21e4f824430952f2013f07bf403"
        "462b79ce739e9346a0d07fab61c3c30cf12d4240261cb3550fcffc63514b7f05"
        "4c8c2cc7fc28232176e3959c274f5639d8dc30107217c42cc419612294afd205"
        "de6ed95ae631486d86b2be054b87abef0e8b62fc9e9a566b92419b16326d9586"
        "06f7fd5b33225e8aa341168e4061f2cda6a8c2429c5fb13aa644ff0da6c86202"
        "d32e0acd798a4a79d2590f1a71543ca45f97f0255fac132d8b4ae03daf9a7502"
        "04000000000000002e57199b1072242d3c8ef684363a3762ef16c7bbddd376ec"
        "b7f4f253b3833c0748a4a73f4069ed60418cc866fa160f6810911e4c3ee419ed"
        "17203fc66f6621049dda756939a32cb50ae3d64e32b5543413354ad2ea170f60"
        "1ba539f5a52d7900970e6a33ad81ece0eb2bbd6b9e74295cfff632db496f1670"
        "bf4df4c1ef5bfe07a339db45d9bba9dd4772191771ee7902481e4ed04965b2bc"
        "d834187c756dd60104000000000000002e57199b1072242d3c8ef684363a3762"
        "ef16c7bbddd376ecb7f4f253b3833c074d716f1835edff0dfd7b1317eec742d0"
        "e8d89b6dd74bbea03edeeee3ffbf5a009ee88a6b161f4724b7539e4fba11138a"
        "54eaecb8b57525c9313e6daefacc6e0193de74b98fefcc57925e3711d742187f"
        "a112808a749abdeb56f8c654f7b5ee0652b069a4ea0f4692c220c86feb326e6f"
        "cb88fe2c130407d7c741770f91de9503"
    ),
    'multi_exp': (
        "3ecc40c36437c68a496a899595af9bafb7468e8c661074d561970b414ca0b684"
        "04000000000000007b11c7e5b1b49ec66ab62912ae70a1d8a8489b020b399d85"
        "c41cb1717a778484cffa43479a5a42cc20ce08421704d8406da826e4aef8eac9"
        "037b3111eb160202000000000000000000000000000000000000000000000000"
        "00000000000000409be8a2aa11487cd895161ceb3969577cf677fe5867032924"
        "104020670e8f258204000000000000009f8c16a841b65033a88fac64b6670852"
        "1d735e468eebc69283e5c4a9740ba48267a1950800ad454c4a3097c0d214d448"
        "199c89e617eae5f30b96d2e91234b104218ca4d5a926a1facc54de034f2d2d71"
        "656079301ec1806382a496acf1a643853825e4a782738fa73da8202a6dffb141"
        "c4c2d453339ec861608aa3ed58bc2c84f0d6f48d5505c52c33084e7360d1412d"
        "73313edd8fdc0a8ef442626c9b3072820f46c1e443746c13195f89a40212fbb1"
        "9bd1e10901803bac4fc464e671562f00fa167fbf302f4d0e00a3c4980a91d62e"
        "34a8a05ca39a23891c4066c1a19ca103c5c9ee58865cd7f939d28153c0c1f26a"
        "a95d24dd97c9cdb8d802ddecd66330820400000000000000d0dbe47521d38d3d"
        "246bacd4e2ca725b8fb721257223d2d46a31b33b548b4402b927d0511286d266"
        "ba822c98c78b6551b9ce16699f58c5dca205f7d935ac77017afc0a68b3a5071e"
        "f019ddf23bd2baff5d897bc4088da274e9523c31b5cdd60224ad24a36d1bb591"
        "fc6e1c7c18e31262a713445fbc26f9af233108657c835a06e12c08c18bb9e5e0"
        "2ff1acf3f03d14333fd1fdf4d50ff1743b2dc95bfb598f07ff0af8b0e1874c83"
        "dafb09a9526dc8743cd94794f449b9c429737510aa3226036ae8d33f04e7b95e"
        "26f5b8012d4c2f859a8ec880488159df79da0a953909310556496372ce8626b1"
        "8ca3c35858dc1193344f3cdd60e8780e3563cf84bf251701"
    ),
}

# JAX `ShuffleArgument.prove` of `_shuffle_statement` (`proof_io.shuffle_to_bytes`)
# and its output deck (compressed c0 points, then c1 points).
SHUFFLE_PIN = {
    'shuffled': (
        "1e08b614face652d6b28e36fbf505c27c66ad0d00cff678c74a4c4eaf86e3387"
        "c37c5fefbd27e49bd2b0b0b10d44f776b51d95c763ca121e0047cedb0f2cdb03"
        "328f9e0b00db19a8f2c55fd72d67fb1754c109594e190850fe647ed378a53987"
        "c22fb298735d9a04a08db5da983fc95967f5e8cb50b27d50d222c62e2c81ca86"
        "9c66f7621b88876cb5491fd1c47a77f9d788511aa531cdf193f899e394e55486"
        "f8949d58f7a6ca5a2b45da9c28ea9c6d045da29a62e1e659f630f4bf70865800"
        "eba5ed841fcd96af3c13fa1e69e928b3db3ef96ce9a0fc3a90cdadc4103a0e82"
        "b1b7fa688e7b16106c216930d1b3b31e5c7449308e2a63ed395738bea3fb1780"
    ),
    'proof': (
        "0200000000000000cda21631728eca9a40aa1b727ef086bc50a6ba522fb734b6"
        "61499806a88a6c8104efd28a3e38e74cb8c22fd98ef6c61a8562154133aadd59"
        "7a5b0aaf78b253010200000000000000d17878a3ef50ea0614b0dcf8c20b9e01"
        "645d88f5895c90cf0bace2defb0cd404e742afa8e3bb93b70e845c7582c6c9b2"
        "ff829ee5f3588bbac188e327c1d2bb85ff00a058ae9bc332da0710e2c3e1a889"
        "76dd294d6f0678b82d8f6026582edb05000000000000000043bf68d93812d749"
        "82bda3e879e56721db26cc613c714f28afd3182c5d8236022a659c019e6e94e7"
        "b59512dc12b7c2610901719ffca03fd2ac977cf05db10c870500000000000000"
        "89022aec966135633c98d80eff9e82880c1f16454b6c850572b650b16be2c285"
        "ef5d2e6289a73fda680872fad96d0a80c203c6b0fc76ea8f01f277f5ad6e9c03"
        "98cc9fb349b347dd17f876ec936a69827c3d118021995a945f7381d40e8b1803"
        "0000000000000000000000000000000000000000000000000000000000000040"
        "b151bcd112b11bce1fc7d71986b43978b53483def036812453d9b30a8a2ec206"
        "02000000000000008dce4f60acf62c8f26a173895ebe42fc3e207307d5aaff14"
        "638576d23a0cc900adf7e2a85ec19f2192a81de3c6f269672b54d17e1871d58f"
        "e86eac90cc41b9030bd7a25f12edb2af2e12d7a41f7149283765afe3762fa9d4"
        "135dcc61501f01050200000000000000bbd14e556086d1d27d9c6be9138d9555"
        "0f2a28ed147faf72256deb412a08e502f992775c06e304da85bc3c1b790f4028"
        "aeb53359e717e4b5478a46f902f02f07c30bd3de559ebf8ec1b8d69422300114"
        "c79bc8f9fce30a79cd97168c532d7405dd34ca4d4a1bf9b19536b61d8db99169"
        "dd39e6f664d68abc2d2b9d2458242c00f036823573f6c8fed9ce1116071f5188"
        "c2ca749529405e067f9a1fa35e472382fde6996c4124bee769e357b19bfb07a9"
        "dff1c90609e67db6ac6bc351ce4b5c833a9b0e78e83e53784b55f003ed3cb1e2"
        "640086e8c38def25b50653ff5062aa020200000000000000da5b996ae659ea1b"
        "f73afb2f93ffd516678f91526506de872a0c3972973f1d0100dc32ea783fe37b"
        "f12ec417b12a7d20fc925791f51f0e19c0e1312936d06402d72e62afb61e2646"
        "6cc79497d786989a7fbf934ad8d8f2c57b3b891a2aa821060200000000000000"
        "da5b996ae659ea1bf73afb2f93ffd516678f91526506de872a0c3972973f1d01"
        "f5e10cf751d4bb3b8519390f6fb0a3319fb918c8baa1fc935b4b6dc4804d0b03"
        "d7757b17362a61c973a83930b5cc2d9a245c062d02cae6eb7254d4307d677d05"
        "9f5f97d997f030912833b427d4ba3f4e10de019c97fea25fdf6b6f8088119b06"
        "0400000000000000fc92040b927f5dce8cdeca6353f5d0cd69cb28080ed35b38"
        "81707e624a2a1e00a6959240b321d96b66068507de5a319502baba26a76e1cd4"
        "1e0fb58d296acf82000000000000000000000000000000000000000000000000"
        "00000000000000401cb22afd889967893d9757e2ed7cb539c06bd5d73a7c70ee"
        "b75443b25a6828850400000000000000178c1ac58d85e5cba6a7d83e8ae0dbfa"
        "d68520b649fe4d4e8a383d82a7fe60039f0ccef2344378b9de6fc3d76a801ce9"
        "05b6b4b47dd015a41c564344aafc0283fac4248784125e65e63515521e8e5c53"
        "214dae903f0a884f8430d8aceab8f9053ca0697de88cd46efe6b17d4f84ab09e"
        "0392e7c28ccbafabf52beb6803a0f30616f9f6d34dbbcac3fc721ffb0064edba"
        "7e4243fc5ad9414cead552c67208ac80ed186b8eb20b4445b994b527bd74b94d"
        "1edaefedbc521268ca3e9b3aab0dc185b44a76612bd925eed837b73a4aeb54a7"
        "bb9553283f377a621a8cc768f91bf403df952b6eb9c1d2aa4c8be190a36e39c9"
        "f501f425aa1fd77ac38f1282ebe0860702000000000000002c5d7771c73b2265"
        "f26b83dab2b0d910cf1ae46c6ce29c4774c5d4e51a9eae00e436b5702bc800da"
        "8d4f12a59fae776123eb949139e5e42e7da463f3abd3130134fbe0845f6a9dae"
        "63bb52d784c915cf4f7f0f36f2576e496f034fd4e494d507f2d5491f7f98f266"
        "78bfc9171bdc64147cc934e8f5e976e9faa1b681c469dd07c78fbabc596f2030"
        "777e83cf8c3a2fee07cbac5eb5900b87074e86808411030705c688e4d60ee232"
        "6dc9d0d78b1f8ee91b613f10c2fdce4e1b665f8b1dfe1605"
    ),
}


def _proof_hex(obj, curve) -> str:
    """A proof dataclass's fields as bytes: compressed points, scalars, and
    u64-length-prefixed lists (the `proof_io` layout), in hex."""

    def enc(o) -> bytes:
        if dataclasses.is_dataclass(o):
            return b"".join(enc(getattr(o, f.name)) for f in dataclasses.fields(o))
        if isinstance(o, tuple) and len(o) == 3 and isinstance(o[2], (bool, np.bool_)):
            return point_to_bytes_compressed(o, curve)
        if isinstance(o, tuple):
            return b"".join(enc(x) for x in o)
        if isinstance(o, list):
            return struct.pack("<Q", len(o)) + b"".join(enc(x) for x in o)
        return scalar_to_bytes(int(o), curve.order.bit_length())

    return enc(obj).hex()


def _subarguments(mods, cv, rng, ck, with_me: bool, **dev):
    """`tests/test_arguments.py`'s statements and proofs, in its draw order.
    `mods`: namespace of the package's zero, svp, hadamard, product, me,
    common, elgamal, FixedBaseTable, TranscriptBatch and _as_matrix."""
    q = cv.host.order
    ts = lambda: mods.TranscriptBatch([b"test-argument"])
    out = {}
    y = rng.scalar(q)
    a_rows = [[rng.scalar(q) for _ in range(N_)] for _ in range(M)]
    b_rows = [[rng.scalar(q) for _ in range(N_)] for _ in range(M)]
    acc = sum(bilinear(a_rows[i], b_rows[i], y, q) for i in range(M - 1)) % q
    rest = bilinear(a_rows[-1], [0] + b_rows[-1][1:], y, q)
    b_rows[-1][0] = (-(acc + rest)) * pow(a_rows[-1][0] * y % q, -1, q) % q
    r_list = [rng.scalar(q) for _ in range(M)]
    s_list = [rng.scalar(q) for _ in range(M)]
    c_a = mods.com_many(ck, a_rows, r_list)
    c_b = mods.com_many(ck, b_rows, s_list)
    out["zero"] = (mods.zero.prove(ck, ts(), rng, a_rows, r_list, b_rows, s_list, y), (c_a, c_b, y))

    av = [rng.scalar(q) for _ in range(N_)]
    v = 1
    for x in av:
        v = v * x % q
    r = rng.scalar(q)
    c_a = mods.com_many(ck, [av], [r])[0]
    out["svp"] = (mods.svp.prove(ck, ts(), rng, av, r, v), (c_a, v))

    a_rows = [[rng.scalar(q) for _ in range(N_)] for _ in range(M)]
    bv = a_rows[0]
    for row in a_rows[1:]:
        bv = vec_hadamard(bv, row, q)
    r_list = [rng.scalar(q) for _ in range(M)]
    s = rng.scalar(q)
    c_a = mods.com_many(ck, a_rows, r_list)
    c_b = mods.com_many(ck, [bv], [s])[0]
    proof = mods.hadamard.prove(ck, ts(), rng, a_rows, r_list, bv, s)
    wrong_b = mods.com_many(ck, [[rng.scalar(q) for _ in range(N_)]], [s])[0]
    out["hadamard"] = (proof, (c_a, c_b, wrong_b))

    a_rows = [[rng.scalar(q) for _ in range(N_)] for _ in range(M)]
    v = 1
    for row in a_rows:
        for x in row:
            v = v * x % q
    r_list = [rng.scalar(q) for _ in range(M)]
    c_a = mods.com_many(ck, a_rows, r_list)
    out["product"] = (mods.product.prove(ck, ts(), rng, a_rows, r_list, v), (c_a, v))
    if not with_me:
        return out

    m, n = 2, N_
    encp = mods.elgamal.setup(cv, rng, **dev)
    pk_host, _ = mods.elgamal.keygen(encp, rng)
    ctx = {"cv": cv, "ck": ck, "enc_gen_table": encp.gen_table,
           "pk_table": mods.FixedBaseTable(cv, pk_host, **dev),
           "gen_table": mods.FixedBaseTable(cv, cv.host.rand_point(rng.rng), **dev)}
    C = mods.elgamal.rand_ciphertexts(cv, rng, m * n, **dev)
    Cm = mods._as_matrix(C, m, n)
    a_rows = [[rng.scalar(q) for _ in range(n)] for _ in range(m)]
    r_list = [rng.scalar(q) for _ in range(m)]
    rho = rng.scalar(q)
    c_a = mods.com_many(ck, a_rows, r_list)
    blind = mods.me._enc_with_generator(ctx, 0, rho)
    target = mods.me._cipher_add_host(cv, blind, mods.me._cipher_msm_flat(cv, C, [x for row in a_rows for x in row]))
    proof = mods.me.prove(ctx, ts(), rng, Cm, a_rows, r_list, rho)
    out["multi_exp"] = (proof, (ctx, Cm, target, c_a, mods.me._cipher_add_host(cv, target, blind)))
    return out


PORT = types.SimpleNamespace(
    zero=zero, svp=svp, hadamard=hadamard, product=product, me=me, com_many=com_many,
    elgamal=elgamal, FixedBaseTable=FixedBaseTable, TranscriptBatch=TranscriptBatch, _as_matrix=_as_matrix,
)


def _port_subarguments(with_me: bool):
    cv = stark_curve()
    rng = GameRng(31337)
    ck = pedersen.setup(cv, rng, N_, device="cpu")
    return cv, ck, _subarguments(PORT, cv, rng, ck, with_me, device="cpu")


def _verify_subarguments(cv, ck, subs):
    """Each proof verifies; each tampered statement raises its string."""
    q = cv.host.order
    ts = lambda: TranscriptBatch([b"test-argument"])
    proof, (c_a, c_b, y) = subs["zero"]
    zero.verify(ck, ts(), proof, c_a, c_b, y)
    bad = dataclasses.replace(proof, r=(proof.r + 1) % q)
    with pytest.raises(ProofVerificationError, match=re.escape(ZERO_ARG)):
        zero.verify(ck, ts(), bad, c_a, c_b, y)
    proof, (c_a, v) = subs["svp"]
    svp.verify(ck, ts(), proof, c_a, v)
    with pytest.raises(ProofVerificationError, match=re.escape(SVP_ARG)):
        svp.verify(ck, ts(), proof, c_a, (v + 1) % q)
    proof, (c_a, c_b, wrong_b) = subs["hadamard"]
    hadamard.verify(ck, ts(), proof, c_a, c_b)
    with pytest.raises(ProofVerificationError, match=re.escape(HADAMARD)):
        hadamard.verify(ck, ts(), proof, c_a, wrong_b)
    proof, (c_a, v) = subs["product"]
    product.verify(ck, ts(), proof, c_a, v)
    with pytest.raises(ProofVerificationError):
        product.verify(ck, ts(), proof, c_a, (v * 2) % q)
    if "multi_exp" in subs:
        proof, (ctx, Cm, target, c_a, bad_target) = subs["multi_exp"]
        me.verify(ctx, ts(), proof, Cm, target, c_a)
        with pytest.raises(ProofVerificationError, match=re.escape(MULTI_EXP)):
            me.verify(ctx, ts(), proof, Cm, bad_target, c_a)


@pytest.mark.slow
def test_subargument_proofs_equal_jax():
    """The four sub-arguments whose provers make no MSM combo (the
    multi-exponentiation argument runs in the next test). `slow`: every
    sub-argument is a part of the `ShuffleArgument` proof, whose bytes the
    tier-1 tests hold equal to the JAX package's."""
    cv, _, subs = _port_subarguments(with_me=False)
    assert {k: _proof_hex(p, cv.host) for k, (p, _) in subs.items()} == {
        k: SUBARG_PIN[k] for k in ("zero", "svp", "hadamard", "product")
    }


@pytest.mark.slow
def test_subarguments_verify_and_multi_exp():
    cv, ck, subs = _port_subarguments(with_me=True)
    assert _proof_hex(subs["multi_exp"][0], cv.host) == SUBARG_PIN["multi_exp"]
    _verify_subarguments(cv, ck, subs)


# ----------------------------------------------------------------- shuffle
def _shuffle_statement(proto, rng_cls, elg, take, **dev):
    """`test_api.py`'s ceremony at (2, 2), then a deck, pi, rho and the
    remasked permuted deck; returns (pp, agg, deck, shuffled, pi, rho, rng)."""
    rng = rng_cls(9)
    pp = proto.setup(rng, 2, 2)
    pk, sk = proto.player_keygen(rng, pp)
    proof_k = proto.prove_key_ownership(rng, pp, pk, sk, b"P")
    agg = proto.compute_aggregate_key(pp, [(pk, proof_k, b"P")])
    deck = elg.rand_ciphertexts(proto.cv, rng, 4, **dev)
    pi = rng.permutation(4)
    rho = [rng.scalar(proto.cv.host.order) for _ in range(4)]
    shuffled = proto.remask_cards(pp, agg, take(deck, list(pi)), rho)
    return pp, agg, deck, shuffled, pi, rho, rng


def _deck_hex(cv, deck) -> str:
    pts = cv.to_host_points(deck.c0) + cv.to_host_points(deck.c1)
    return b"".join(point_to_bytes_compressed(p, cv.host) for p in pts).hex()


@pytest.fixture(scope="module")
def shuffle_env():
    proto = DLCards(device="cpu")
    pp, agg, deck, shuffled, pi, rho, rng = _shuffle_statement(proto, GameRng, elgamal, cipher_take, device="cpu")
    ts = TranscriptBatch.fixed(SHUFFLE_RNG_SEED, 1)
    proof = api.ShuffleArgument().prove((pp, agg), (deck, shuffled), (pi, rho), ts, rng)
    return types.SimpleNamespace(proto=proto, pp=pp, agg=agg, deck=deck, shuffled=shuffled, proof=proof)


def _host_verify(env, deck_out, proof):
    ts = TranscriptBatch.fixed(SHUFFLE_RNG_SEED, 1)
    api.ShuffleArgument().verify((env.pp, env.agg), (env.deck, deck_out), proof, ts)


def test_shuffle_argument_equals_jax(shuffle_env):
    h = shuffle_env.pp.cv.host
    assert _deck_hex(shuffle_env.pp.cv, shuffle_env.shuffled) == SHUFFLE_PIN["shuffled"]
    assert proof_io.shuffle_to_bytes(shuffle_env.proof, h).hex() == SHUFFLE_PIN["proof"]
    assert proof_io.shuffle_proof_size(shuffle_env.proof, h) == len(SHUFFLE_PIN["proof"]) // 2


def test_host_verifier_accepts_jax_proof(shuffle_env):
    h = shuffle_env.pp.cv.host
    _host_verify(shuffle_env, shuffle_env.shuffled, proof_io.shuffle_from_bytes(bytes.fromhex(SHUFFLE_PIN["proof"]), h))


def test_substituted_deck_fails_hadamard(shuffle_env):
    bogus = elgamal.rand_ciphertexts(shuffle_env.pp.cv, GameRng(123), 4, "cpu")
    with pytest.raises(ProofVerificationError) as ei:
        _host_verify(shuffle_env, bogus, shuffle_env.proof)
    assert ei.value.name == HADAMARD


def test_staged_verifier_accepts_host_proof(shuffle_env):
    env = shuffle_env
    env.proto.verify_shuffle(env.pp, env.agg, env.deck, env.shuffled, env.proof)


@pytest.mark.slow
def test_pins_against_live_jax(shuffle_env):
    """Recompute the pins through the JAX package, and let the JAX host
    verifier accept the port's proof bytes."""
    from mental_poker_tpu.arguments import hadamard as jhad
    from mental_poker_tpu.arguments import multi_exponentiation as jme
    from mental_poker_tpu.arguments import product as jprod
    from mental_poker_tpu.arguments import single_value_product as jsvp
    from mental_poker_tpu.arguments import zero as jzero
    from mental_poker_tpu.arguments.common import com_many as jcom_many
    from mental_poker_tpu.arguments.shuffle import _as_matrix as j_as_matrix
    from mental_poker_tpu.crypto import elgamal as jelgamal
    from mental_poker_tpu.crypto import pedersen as jpedersen
    from mental_poker_tpu.crypto.transcript import TranscriptBatch as JTranscriptBatch
    from mental_poker_tpu.models.round import cipher_take as jcipher_take
    from mental_poker_tpu.ops import curve as jcurve
    from mental_poker_tpu.ops.msm import FixedBaseTable as JFixedBaseTable
    from mental_poker_tpu.protocol import api as japi
    from mental_poker_tpu.protocol.dl_cards import DLCards as JDLCards
    from mental_poker_tpu.utils.rand import GameRng as JGameRng

    jmods = types.SimpleNamespace(
        zero=jzero, svp=jsvp, hadamard=jhad, product=jprod, me=jme, com_many=jcom_many,
        elgamal=jelgamal, FixedBaseTable=JFixedBaseTable, TranscriptBatch=JTranscriptBatch, _as_matrix=j_as_matrix,
    )
    jc = jcurve.stark_curve()
    rng = JGameRng(31337)
    ck = jpedersen.setup(jc, rng, N_)
    subs = _subarguments(jmods, jc, rng, ck, with_me=True)
    assert {k: _proof_hex(p, jc.host) for k, (p, _) in subs.items()} == SUBARG_PIN

    d = JDLCards()
    pp, agg, deck, shuffled, pi, rho, rng = _shuffle_statement(d, JGameRng, jelgamal, jcipher_take)
    ts = JTranscriptBatch.fixed(SHUFFLE_RNG_SEED, 1)
    proof = japi.ShuffleArgument().prove((pp, agg), (deck, shuffled), (pi, rho), ts, rng)
    assert _deck_hex(jc, shuffled) == SHUFFLE_PIN["shuffled"]
    assert jproof_io.shuffle_to_bytes(proof, jc.host).hex() == SHUFFLE_PIN["proof"]
    port_bytes = proof_io.shuffle_to_bytes(shuffle_env.proof, jc.host)
    japi.ShuffleArgument().verify(
        (pp, agg), (deck, shuffled), jproof_io.shuffle_from_bytes(port_bytes, jc.host), JTranscriptBatch.fixed(SHUFFLE_RNG_SEED, 1)
    )
