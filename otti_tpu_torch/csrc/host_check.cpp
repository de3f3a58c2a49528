// The device arithmetic of field.cuh compiled for the host, so that a CPU
// test can hold the very code the kernels run against Python integers:
//   g++ -O2 -std=c++17 -shared -fPIC -o libotti_field_host.so host_check.cpp
// No kernel is built from this file.
#include "field.cuh"

extern "C" void otti_host_set_consts(const int32_t* consts) {
  set_field_consts(consts);
}

// out[i] = a[i] * b[i] mod m over [n, 22] limb rows, canonical.
extern "C" void otti_host_mul(const int32_t* a, const int32_t* b, int32_t* out,
                              long long n, int field) {
  for (long long i = 0; i < n; ++i) {
    const Fe x = fe_pack(a + i * OTTI_NL), y = fe_pack(b + i * OTTI_NL);
    const Fe z = field == FIELD_SCALAR ? fe_mul<FIELD_SCALAR>(x, y)
                                       : fe_mul<FIELD_BASE>(x, y);
    fe_unpack(z, out + i * OTTI_NL);
  }
}

// op 0: canon(a); 1: canon(a) + canon(b); 2: canon(a) - canon(b).
extern "C" void otti_host_addsub(const int32_t* a, const int32_t* b, int32_t* out,
                                 long long n, int field, int op) {
  for (long long i = 0; i < n; ++i) {
    Fe z;
    if (field == FIELD_SCALAR) {
      const Fe x = fe_canon<FIELD_SCALAR>(fe_pack(a + i * OTTI_NL));
      const Fe y = fe_canon<FIELD_SCALAR>(fe_pack(b + i * OTTI_NL));
      z = op == 0 ? x : op == 1 ? fe_add<FIELD_SCALAR>(x, y) : fe_sub<FIELD_SCALAR>(x, y);
    } else {
      const Fe x = fe_canon<FIELD_BASE>(fe_pack(a + i * OTTI_NL));
      const Fe y = fe_canon<FIELD_BASE>(fe_pack(b + i * OTTI_NL));
      z = op == 0 ? x : op == 1 ? fe_add<FIELD_BASE>(x, y) : fe_sub<FIELD_BASE>(x, y);
    }
    fe_unpack(z, out + i * OTTI_NL);
  }
}
