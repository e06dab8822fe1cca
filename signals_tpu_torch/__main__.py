"""Package entry: the headless patcher REPL on the GPU
(``python -m signals_tpu_torch [library modules...]``; reference
``src/signals/__main__.py`` starts the Qt GUI).  A caller that wants the
CPU calls ``signals_tpu_torch.map.control.main(argv, device='cpu')``."""

import faulthandler
import sys

import signals_tpu_torch.map.control

if __name__ == '__main__':
    faulthandler.enable()
    signals_tpu_torch.map.control.main(sys.argv[1:])
